"""M1 end-to-end: one-level (restricted) additive Schwarz + CG on Poisson.

This is the reference's first shipped config (one-level Schwarz + CG).  Checks:
solution correctness vs scipy, preconditioning effectiveness, and the
standard-vs-restricted semantics of schwarz.hh:138-143.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse.linalg as spla

from ddm_jax.config import ParamTree
from ddm_jax.core.indexmaps import pou_weights
from ddm_jax.core.setup import setup_topology
from ddm_jax.fem import structured_grid, read_msh
from ddm_jax.fem.discretize import Discretization
from ddm_jax.fem import problems as prob
from ddm_jax.precond.schwarz import build_schwarz
from ddm_jax.solvers.krylov import cg_solve, operator_of, prec_of


def poisson_setup(cells=(24, 24), parts=(2, 2), overlap=2, problem=None):
    grid = structured_grid(cells)
    disc = Discretization(grid, problem or prob.simple())
    Ac, rhs, g = disc.constrained_system()
    topo, _ = setup_topology(disc, overlap=overlap, parts=parts)
    return disc, Ac, rhs, g, topo


def schwarz_ptree(stype="restricted", solver="cholesky"):
    return ParamTree(
        {"schwarz": {"type": stype, "subdomain_solver": {"type": solver}}}
    )


def test_as_cg_converges_and_matches_scipy():
    # CG requires the symmetric (standard) Schwarz variant; the restricted
    # variant is nonsymmetric and is paired with GMRES/BiCGStab below, as in
    # the reference's poisson.ini (restartedgmressolver + schwarz.type
    # restricted).
    disc, Ac, rhs, g, topo = poisson_setup()
    P = build_schwarz(Ac, topo, None, schwarz_ptree("standard"))
    res = cg_solve(
        operator_of(Ac), prec_of(P), rhs, jnp.zeros_like(rhs), reduction=1e-10,
        maxit=200,
    )
    assert bool(res.converged)
    Asp = disc.pattern.to_scipy(Ac).tocsc()
    x_ref = spla.spsolve(Asp, np.asarray(rhs))
    np.testing.assert_allclose(np.asarray(res.x), x_ref, atol=1e-7)
    # preconditioning must beat plain CG
    res_plain = cg_solve(
        operator_of(Ac), None, rhs, jnp.zeros_like(rhs), reduction=1e-10, maxit=500
    )
    assert int(res.iterations) < int(res_plain.iterations)


@pytest.mark.parametrize("pt", ["standard", "trivial", "distance"])
def test_ras_gmres_converges(pt):
    from ddm_jax.solvers.krylov import gmres_solve

    disc, Ac, rhs, g, topo = poisson_setup(cells=(16, 16))
    pou = pou_weights(topo, pt)
    P = build_schwarz(Ac, topo, pou, schwarz_ptree("restricted"))
    res = gmres_solve(
        operator_of(Ac), prec_of(P), rhs, jnp.zeros_like(rhs), reduction=1e-8,
        maxit=300, restart=50,
    )
    assert bool(res.converged), f"restricted/{pt} did not converge"
    assert int(res.iterations) < 30


def test_ras_bicgstab_converges():
    from ddm_jax.solvers.krylov import bicgstab_solve

    disc, Ac, rhs, g, topo = poisson_setup(cells=(16, 16))
    pou = pou_weights(topo, "distance")
    P = build_schwarz(Ac, topo, pou, schwarz_ptree("restricted"))
    res = bicgstab_solve(
        operator_of(Ac), prec_of(P), rhs, jnp.zeros_like(rhs), reduction=1e-8,
        maxit=300,
    )
    assert bool(res.converged)
    import scipy.sparse.linalg as spla

    x_ref = spla.spsolve(disc.pattern.to_scipy(Ac).tocsc(), np.asarray(rhs))
    np.testing.assert_allclose(np.asarray(res.x), x_ref, atol=1e-6)


def test_lu_and_cholesky_factorizations_agree():
    disc, Ac, rhs, g, topo = poisson_setup(cells=(16, 16))
    pou = pou_weights(topo, "distance")
    P_lu = build_schwarz(Ac, topo, pou, schwarz_ptree(solver="umfpack"))
    P_ch = build_schwarz(Ac, topo, pou, schwarz_ptree(solver="cholmod"))
    d = jnp.asarray(np.random.default_rng(0).normal(size=rhs.shape))
    np.testing.assert_allclose(
        np.asarray(P_lu.apply(d)), np.asarray(P_ch.apply(d)), rtol=1e-9, atol=1e-10
    )


def test_unstructured_mesh_ras_gmres():
    import os

    path = "/root/reference/data/unitsquare.msh"
    if not os.path.exists(path):
        pytest.skip("reference mesh unavailable")
    grid = read_msh(path)
    disc = Discretization(grid, prob.simple())
    Ac, rhs, g = disc.constrained_system()
    topo, _ = setup_topology(disc, overlap=2, n_sub=8)
    from ddm_jax.solvers.krylov import gmres_solve

    pou = pou_weights(topo, "distance")
    P = build_schwarz(Ac, topo, pou, schwarz_ptree())
    res = gmres_solve(
        operator_of(Ac), prec_of(P), rhs, jnp.zeros_like(rhs), reduction=1e-10,
        maxit=300, restart=50,
    )
    assert bool(res.converged)
    Asp = disc.pattern.to_scipy(Ac).tocsc()
    x_ref = spla.spsolve(Asp, np.asarray(rhs))
    np.testing.assert_allclose(np.asarray(res.x), x_ref, atol=1e-6)


def test_history_is_monotone_overall():
    disc, Ac, rhs, g, topo = poisson_setup(cells=(16, 16))
    P = build_schwarz(Ac, topo, None, schwarz_ptree("standard"))
    res = cg_solve(
        operator_of(Ac), prec_of(P), rhs, jnp.zeros_like(rhs), reduction=1e-10,
        maxit=200,
    )
    h = np.asarray(res.history)
    h = h[~np.isnan(h)]
    assert h[-1] < 1e-10 * h[0]


def test_dd_apply_matches_f64():
    """Double-single (dd) subdomain apply: the stored operator hi+lo equals
    the f64 inverse to ~2^-48; the apply result matches the f64 apply to
    f32-accumulation noise."""
    import jax.numpy as jnp
    from ddm_jax.solvers.direct import (
        BatchedInverseDD, dd_split, factor_batched,
    )

    rng = np.random.default_rng(3)
    A = jnp.asarray(rng.standard_normal((4, 40, 40)))
    A = jnp.einsum("spq,srq->spr", A, A) + 40 * jnp.eye(40)[None]
    f64 = factor_batched(A, "cholesky", mode="inverse")
    h, l = dd_split(f64.inv)
    # representation exactness
    np.testing.assert_allclose(
        np.asarray(h.astype(jnp.float64) + l.astype(jnp.float64)),
        np.asarray(f64.inv), rtol=3e-15, atol=0,
    )
    dd = BatchedInverseDD(inv_hi=h, inv_lo=l)
    b = jnp.asarray(rng.standard_normal((4, 40)))
    x64 = f64.solve(b)
    xdd = dd.solve(b)
    err = float(jnp.abs(xdd - x64).max() / jnp.abs(x64).max())
    assert err < 1e-5, err
    # multi-RHS path with sparse defect correction (was silently
    # skipped for 3-D inputs) — refinement must run and tighten the result
    import dataclasses

    cols = jnp.broadcast_to(jnp.arange(40, dtype=jnp.int32), (4, 40, 40))
    ddr = dataclasses.replace(dd, sub_vals=A, sub_cols=cols, steps=2)
    B = jnp.asarray(rng.standard_normal((4, 40, 3)))
    X64 = f64.solve(B)
    Xdd = ddr.solve(B)
    errB = float(jnp.abs(Xdd - X64).max() / jnp.abs(X64).max())
    assert errB < 1e-9, errB  # 2 exact-residual steps beat the raw dd noise
    # and columns match the vector path (einsum accumulation order differs
    # between the sq->sp and sqk->spk contractions, so not bitwise)
    x_col = ddr.solve(B[..., 0])
    np.testing.assert_allclose(
        np.asarray(Xdd[..., 0]), np.asarray(x_col),
        atol=1e-10 * float(jnp.abs(X64).max()),
    )


def test_two_level_dd_precision_converges_like_f64():
    """GenEO-RAS with schwarz precision=dd: the same TRUE convergence target
    is reached (solve_from_config auto-enables verified termination for
    reduced-precision preconditioners — the Givens estimate alone reports
    false convergence), at a bounded iteration overhead vs f64 (the dd
    apply's incoherent ~1e-7 noise re-excites small-eigenvalue directions
    each cycle; measured ~1.6x here — unlike the plain-f32 path, which
    stalls outright on high-contrast problems)."""
    import jax.numpy as jnp
    from ddm_jax.api import (
        build_preconditioner, default_ptree, setup_problem, solve,
    )
    from ddm_jax.fem import problems as prob

    pt = default_ptree()
    pt["gridsize"] = 48
    pt["solver.reduction"] = 1e-8
    pt["coarsespace.type"] = "geneo"
    pt["coarse_solver.type"] = "cholesky"
    pt["geneo.eigensolver.nev"] = 6
    p = setup_problem(pt, problem=prob.islands(), parts=(4, 4))
    res64 = solve(p)
    assert bool(res64.converged)

    pt["schwarz.subdomain_solver.precision"] = "dd"
    pt["coarse_solver.precision"] = "dd"
    prec = build_preconditioner(p)
    res_dd = solve(p, prec=prec)
    assert bool(res_dd.converged)
    # honest convergence: the true (unpreconditioned) residual matches the
    # f64 run's order of magnitude — not just the recurrence estimate
    import numpy as np

    def true_res(r):
        return float(jnp.linalg.norm(p.A.mv(r.x) - p.rhs)
                     / jnp.linalg.norm(p.rhs))

    assert true_res(res_dd) < 10 * max(true_res(res64), 1e-12)
    assert int(res_dd.iterations) <= 2 * int(res64.iterations), (
        int(res_dd.iterations), int(res64.iterations))
