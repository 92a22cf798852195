"""M2: Galerkin coarse preconditioner — exact fixture + two-level tests.

Ports the reference's hand-computed 4-rank fixture
(tests/test_galerkin_coarse_matrix.cc): a 9x9 1D-Laplacian-like matrix
distributed additively over 4 subdomains with explicit index sets; checks
(a) overlap extension at 6 layers reproduces the full matrix,
(b) the POU sums to 1,
(c) the Galerkin coarse matrix matches the embedded expected values to 1e-12.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sps

from ddm_jax.config import ParamTree
from ddm_jax.coarse.basis import CoarseBasis, finalize_basis
from ddm_jax.coarse.pou_space import pou_coarse_space
from ddm_jax.core.indexmaps import build_topology, pou_weights
from ddm_jax.core.setup import setup_topology
from ddm_jax.core.sparse import EllPattern
from ddm_jax.fem import structured_grid
from ddm_jax.fem import problems as prob
from ddm_jax.fem.discretize import Discretization
from ddm_jax.precond.combined import CombinedPreconditioner
from ddm_jax.precond.extract import extract_subdomain_dense
from ddm_jax.precond.galerkin import (
    build_galerkin,
    galerkin_coarse_matrix,
    galerkin_coarse_matrix_local,
)
from ddm_jax.core.indexmaps import extraction_map
from ddm_jax.precond.schwarz import build_schwarz
from ddm_jax.solvers.krylov import cg_solve, operator_of, prec_of


# -- the reference fixture (tests/test_galerkin_coarse_matrix.cc:21-67) -----

def fixture_matrix():
    """9x9: diag 1..9, superdiag 18..25, subdiag 10..17."""
    rows, cols, vals = [], [], []
    for i in range(9):
        rows.append(i), cols.append(i), vals.append(float(i + 1))
    for i in range(8):
        rows.append(i), cols.append(i + 1), vals.append(float(18 + i))
        rows.append(i + 1), cols.append(i), vals.append(float(10 + i))
    return np.array(rows), np.array(cols), np.array(vals)


EXPECTED_COARSE = np.array(
    [
        [29.52777777777778, 27.02777777777778, 7.277777777777778, 0.0],
        [21.69444444444445, 28.11111111111111, 21.19444444444444, 8.166666666666666],
        [4.611111111111111, 18.52777777777778, 34.11111111111111, 36.91666666666666],
        [0.0, 5.499999999999999, 31.58333333333333, 50.75],
    ]
)


def fixture_topology(overlap):
    rows, cols, vals = fixture_matrix()
    adj = sps.csr_matrix((np.ones(rows.size), (rows, cols)), shape=(9, 9))
    m_rows = [0] * 3 + [1] * 3 + [2] * 3 + [3] * 3
    m_cols = [0, 1, 2, 2, 3, 4, 4, 5, 6, 6, 7, 8]
    M0 = sps.csr_matrix(
        (np.ones(12, np.int8), (m_rows, m_cols)), shape=(4, 9)
    )
    owner = np.array([0, 0, 0, 1, 1, 2, 2, 3, 3], dtype=np.int32)
    return build_topology(adj, M0, owner, overlap)


def fixture_ell():
    rows, cols, vals = fixture_matrix()
    pat = EllPattern.from_coo(rows, cols, 9)
    return pat, pat.assemble(jnp.asarray(vals))


def fixture_pou(topo):
    """The fixture's POU: 1/#subdomains-sharing, NOT zeroed on boundaries
    (test_galerkin_coarse_matrix.cc:222-246)."""
    count = np.zeros(10)
    np.add.at(count, topo.sub2glob, topo.valid.astype(float))
    w = np.where(topo.valid, 1.0 / np.maximum(count[topo.sub2glob], 1), 0.0)
    return w


def test_overlap6_reproduces_full_matrix():
    topo = fixture_topology(overlap=6)
    assert (topo.sizes == 9).all()
    pat, ell = fixture_ell()
    lc = extraction_map(topo, np.asarray(ell.colsT).T)
    A_sub = extract_subdomain_dense(
        ell, jnp.asarray(topo.sub2glob), jnp.asarray(topo.valid), jnp.asarray(lc),
        unit_padding_diag=False,
    )
    full = pat.to_scipy(ell).toarray()
    np.testing.assert_allclose(np.asarray(A_sub[0][:9, :9]), full, atol=1e-16)


def test_fixture_pou_sums_to_one():
    topo = fixture_topology(overlap=1)
    w = fixture_pou(topo)
    total = np.zeros(10)
    np.add.at(total, topo.sub2glob, w)
    np.testing.assert_allclose(total[:9], 1.0, atol=1e-15)


def test_galerkin_coarse_matrix_fixture():
    topo = fixture_topology(overlap=1)
    assert list(topo.sizes) == [4, 5, 5, 4]
    pat, ell = fixture_ell()
    w = fixture_pou(topo)
    # basis = pou * template(=1), unnormalized, as the fixture's old API.
    # The expected matrix is the true global Galerkin product
    # E[i,j] = v_i^T A v_j (nonsymmetric since the fixture matrix is):
    # e.g. E[0,1] = v_0.(A v_1) = 27.0277..., hand-checked.
    V = jnp.asarray(w)[:, None, :]
    basis = CoarseBasis(V=V, active=jnp.ones((4, 1), bool))
    E = galerkin_coarse_matrix(ell, jnp.asarray(topo.sub2glob), basis)
    np.testing.assert_allclose(np.asarray(E), EXPECTED_COARSE, atol=1e-12)


def test_global_equals_local_for_boundary_zero_basis():
    # with POU-finalized vectors (zero on subdomain boundaries), the
    # reference's local formula equals the true Galerkin product
    grid = structured_grid((16, 16))
    disc = Discretization(grid, prob.simple())
    A, rhs, g = disc.constrained_system()
    topo, _ = setup_topology(disc, overlap=2, parts=(2, 2))
    pou = pou_weights(topo, "standard")
    basis = pou_coarse_space(topo, pou)
    lc = extraction_map(topo, np.asarray(A.colsT).T)
    A_sub = extract_subdomain_dense(
        A, jnp.asarray(topo.sub2glob), jnp.asarray(topo.valid), jnp.asarray(lc)
    )
    Eg = galerkin_coarse_matrix(A, jnp.asarray(topo.sub2glob), basis)
    El = galerkin_coarse_matrix_local(
        A_sub, jnp.asarray(topo.sub2glob), basis, topo.n_glob
    )
    np.testing.assert_allclose(np.asarray(Eg), np.asarray(El.T), atol=1e-10)
    # and symmetric
    np.testing.assert_allclose(np.asarray(Eg), np.asarray(Eg).T, atol=1e-10)


def two_level_setup(cells=(32, 32), parts=(4, 4), overlap=2):
    grid = structured_grid(cells)
    disc = Discretization(grid, prob.simple())
    A, rhs, g = disc.constrained_system()
    topo, _ = setup_topology(disc, overlap=overlap, parts=parts)
    pou = pou_weights(topo, "distance")
    return disc, A, rhs, topo, pou


def test_two_level_pou_lifts_lowest_mode():
    """The Nicolaides coarse space must lift lambda_min of the preconditioned
    operator (the two-level theory statement; raw CG counts on homogeneous
    Poisson at this size are dominated by spectral clustering and are not a
    meaningful check — GenEO on heterogeneous problems is, see
    test_geneo.py)."""
    disc, A, rhs, topo, pou = two_level_setup(cells=(48, 48), parts=(6, 6),
                                              overlap=1)
    pt = ParamTree(
        {"schwarz": {"type": "standard", "subdomain_solver": {"type": "cholesky"}},
         "coarse_solver": {"type": "lu"}}
    )
    fine = build_schwarz(A, topo, None, pt)
    basis = pou_coarse_space(topo, pou, dirichlet_mask=disc.dirichlet_mask)
    coarse = build_galerkin(A, topo, basis, pt)
    both = CombinedPreconditioner(precs=(fine, coarse), mode="additive")

    Ad = disc.pattern.to_scipy(A).toarray()
    n = Ad.shape[0]
    import jax

    def lam_min(p):
        M = np.asarray(jax.vmap(p.apply)(jnp.eye(n))).T
        w = np.real(np.linalg.eigvals(M @ Ad))
        return w[w > 1e-10].min()

    l1, l2 = lam_min(fine), lam_min(both)
    assert l2 > 2.0 * l1

    res2 = cg_solve(operator_of(A), prec_of(both), rhs, jnp.zeros_like(rhs),
                    reduction=1e-10, maxit=300)
    assert bool(res2.converged)


def test_multiplicative_mode():
    disc, A, rhs, topo, pou = two_level_setup(cells=(24, 24))
    pt = ParamTree(
        {"schwarz": {"type": "restricted", "subdomain_solver": {"type": "cholesky"}},
         "coarse_solver": {"type": "lu"}}
    )
    from ddm_jax.solvers.krylov import gmres_solve

    fine = build_schwarz(A, topo, pou, pt)
    basis = pou_coarse_space(topo, pou)
    coarse = build_galerkin(A, topo, basis, pt)
    add = CombinedPreconditioner(precs=(fine, coarse), mode="additive")
    mult = CombinedPreconditioner(precs=(fine, coarse), op=A, mode="multiplicative")
    r_add = gmres_solve(operator_of(A), prec_of(add), rhs, jnp.zeros_like(rhs),
                        reduction=1e-10, maxit=300, restart=50)
    r_mul = gmres_solve(operator_of(A), prec_of(mult), rhs, jnp.zeros_like(rhs),
                        reduction=1e-10, maxit=300, restart=50)
    assert bool(r_add.converged) and bool(r_mul.converged)
    # multiplicative is at least as good as additive here
    assert int(r_mul.iterations) <= int(r_add.iterations)


def test_multiplicative_requires_op():
    disc, A, rhs, topo, pou = two_level_setup(cells=(16, 16))
    pt = ParamTree({"schwarz": {"subdomain_solver": {"type": "lu"}}})
    fine = build_schwarz(A, topo, pou, pt)
    c = CombinedPreconditioner(precs=(fine, fine), mode="multiplicative")
    with pytest.raises(ValueError, match="multiplicative"):
        c.apply(rhs)


def test_pairs_coarse_matrix_matches_global():
    """galerkin_coarse_matrix_pairs == the true Galerkin product for
    POU-finalized bases (GenEO on islands), symmetric AND nonsymmetric."""
    import jax.numpy as jnp
    from ddm_jax.api import default_ptree, setup_problem
    from ddm_jax.coarse.geneo import geneo_coarse_space
    from ddm_jax.fem import problems as prob
    from ddm_jax.precond.extract import extract_subdomain_dense
    from ddm_jax.precond.galerkin import (
        galerkin_coarse_matrix,
        galerkin_coarse_matrix_pairs,
    )

    pt = default_ptree()
    pt["gridsize"] = 32
    pt["geneo.eigensolver.nev"] = 4
    p = setup_problem(pt, problem=prob.islands(), parts=(3, 3))
    basis = geneo_coarse_space(p, pt)
    E_global = galerkin_coarse_matrix(
        p.A, jnp.asarray(p.topo.sub2glob), basis)
    lc = extraction_map(p.topo, np.asarray(p.A.colsT).T)
    A_sub = extract_subdomain_dense(
        p.A, jnp.asarray(p.topo.sub2glob), jnp.asarray(p.topo.valid),
        jnp.asarray(lc))
    E_pairs = galerkin_coarse_matrix_pairs(A_sub, p.topo, basis)
    scale = float(jnp.abs(E_global).max())
    np.testing.assert_allclose(
        np.asarray(E_pairs), np.asarray(E_global), atol=1e-12 * scale)


def test_pairs_shift_path_matches_general_gather():
    """The rect-canvas shift-grouped pair gather (_pairs_device_shift) must
    reproduce the general gather formulation exactly: per pair the same
    values contract in the same order, so the results are bitwise equal."""
    from ddm_jax.api import default_ptree, setup_problem
    from ddm_jax.coarse.geneo import geneo_coarse_space
    from ddm_jax.fem import problems as prob
    from ddm_jax.precond.extract import extract_subdomain_dense
    from ddm_jax.precond.galerkin import (
        _pairs_device,
        _pairs_maps,
        _pairs_shift_maps,
        galerkin_coarse_matrix_pairs,
    )

    pt = default_ptree()
    pt["gridsize"] = 32
    pt["geneo.eigensolver.nev"] = 3
    p = setup_problem(pt, problem=prob.islands(), parts=(4, 4))
    assert getattr(p.topo, "rect", None) is not None
    basis = geneo_coarse_space(p, pt)
    lc = extraction_map(p.topo, np.asarray(p.A.colsT).T)
    A_sub = extract_subdomain_dense(
        p.A, jnp.asarray(p.topo.sub2glob), jnp.asarray(p.topo.valid),
        jnp.asarray(lc))
    E_shift = galerkin_coarse_matrix_pairs(A_sub, p.topo, basis)
    # the shift grouping must actually engage (all scalar Q1 rects conform)
    shifts, sgroups, gen_idx = _pairs_shift_maps(p.topo)
    assert sum(int(g.shape[0]) for g in sgroups) > 0
    n_sub, nev, _ = basis.V.shape
    pi, pj, m_pair = _pairs_maps(p.topo)
    E_gen = _pairs_device(A_sub, basis.V, pi, pj, m_pair,
                          n_sub=n_sub, nev=nev)
    assert np.array_equal(np.asarray(E_shift), np.asarray(E_gen))


def test_coarse_newton_rtol_flows_and_matches_direct(monkeypatch):
    """coarse_solver.newton_rtol + construction=newton must reach
    newton_inverse_batched for the coarse factor (precond/galerkin.py), and
    the resulting two-level solve must match the direct-factorization coarse
    path (Newton error is multiplicative; the coarse apply additionally
    iteratively refines against the stored E)."""
    import ddm_jax.solvers.direct as direct
    from ddm_jax.api import default_ptree, setup_problem, solve

    def make_pt():
        pt = default_ptree()
        pt["gridsize"] = 32
        pt["coarsespace.type"] = "geneo"
        pt["coarse_solver.type"] = "cholesky"
        pt["geneo.eigensolver.nev"] = 3
        pt["solver.reduction"] = 1e-8
        return pt

    p = setup_problem(make_pt(), problem=prob.islands(), parts=(2, 2))
    res_direct = solve(p)

    seen = {}
    orig = direct.newton_inverse_batched

    def spy(A, store_dtype=None, rtol=None, max_steps=None):
        seen["rtol"] = rtol
        seen["shape"] = tuple(A.shape)
        return orig(A, store_dtype=store_dtype, rtol=rtol,
                    max_steps=max_steps)

    monkeypatch.setattr(direct, "newton_inverse_batched", spy)
    pt = make_pt()
    pt["coarse_solver.construction"] = "newton"
    pt["coarse_solver.newton_rtol"] = 1e-6
    p2 = setup_problem(pt, problem=prob.islands(), parts=(2, 2))
    res_newton = solve(p2)
    assert seen["rtol"] == pytest.approx(1e-6)
    assert seen["shape"][0] == 1  # the (1, nc, nc) coarse batch
    assert bool(res_newton.converged)
    # exact-grade rtol -> same preconditioner quality as the direct factor
    assert abs(int(res_newton.iterations) - int(res_direct.iterations)) <= 1

    # the Newton-built coarse inverse must be exactly symmetric (CG safety)
    from ddm_jax.api import build_preconditioner
    from ddm_jax.solvers.direct import BatchedInverse

    prec = build_preconditioner(p2)
    coarse = prec.precs[1].coarse
    assert isinstance(coarse, BatchedInverse)
    inv = np.asarray(coarse.inv[0])
    assert np.array_equal(inv, inv.T)


def test_coarse_newton_skips_indefinite_diag():
    """A cholesky-declared coarse path with a non-positive diagonal must NOT
    go through the scaled Newton seed (which would produce ~1e150 scale
    factors); it falls back to the exact pipeline."""
    from ddm_jax.precond.galerkin import build_galerkin
    from ddm_jax.coarse.basis import CoarseBasis

    # drive build_galerkin with a basis whose Galerkin product has a zero
    # diagonal entry (zero vector on an active slot) — the scaled-seed
    # precondition (strictly positive diagonal) fails
    topo = fixture_topology(overlap=1)
    _, ell = fixture_ell()
    nev = 1
    V = np.zeros((topo.n_sub, nev, topo.n_pad))
    # all-zero active basis vector -> E diagonal entry 0
    basis = CoarseBasis(
        V=jnp.asarray(V),
        active=jnp.ones((topo.n_sub, nev), bool),
    )
    pt = ParamTree({"coarse_solver": {
        "type": "cholesky", "construction": "newton", "newton_rtol": 1e-6,
    }})
    import ddm_jax.solvers.direct as direct

    called = {"newton": False}
    orig = direct.newton_inverse_batched

    def spy(*a, **k):
        called["newton"] = True
        return orig(*a, **k)

    import unittest.mock as mock

    with mock.patch.object(direct, "newton_inverse_batched", spy):
        prec = build_galerkin(ell, topo, basis, pt, method="global")
    assert called["newton"] is False
    assert prec is not None
