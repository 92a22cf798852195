"""Batched LOBPCG — the block-eigensolver subsystem the reference's snapshot
lost (SURVEY.md caveats).  Ports the intent of the reference's eigensolver
tests: cross-validation of two independent eigensolvers on the same pencils
(dune/ddm/test/test_eigensolver.cc:230-240) and a decomposition/residual
identity on a matrix with known spectrum (test_lanczos_step.cc:181-262)."""

import numpy as np
import jax.numpy as jnp
import pytest

from ddm_jax.eigen import EigensolverParams, solve_gevp_dense
from ddm_jax.eigen.lobpcg import lobpcg_gevp


def make_pencils(n_sub=3, p=40, seed=0):
    rng = np.random.default_rng(seed)
    A = np.zeros((n_sub, p, p))
    C = np.zeros((n_sub, p, p))
    for s in range(n_sub):
        Q = rng.normal(size=(p, p))
        A[s] = Q @ np.diag(rng.uniform(0.5, 50, p)) @ Q.T
        R = rng.normal(size=(p, p))
        C[s] = R @ R.T + 0.1 * np.eye(p)
    return jnp.asarray(A), jnp.asarray(C)


def test_lobpcg_known_spectrum():
    """Diagonal pencil with known eigenvalues (the reference's
    test_lanczos_step diagonal-matrix check)."""
    p, m = 64, 5
    diag = np.arange(1.0, p + 1)
    A = jnp.asarray(np.diag(diag)[None])
    C = jnp.asarray(np.eye(p)[None])
    rng = np.random.default_rng(1)
    X0 = jnp.asarray(rng.normal(size=(1, p, m)))
    prec = jnp.asarray(np.diag(1.0 / diag)[None])
    lam, V, rn, _ = lobpcg_gevp(A, C, X0, prec_inv=prec, maxit=80)
    np.testing.assert_allclose(np.asarray(lam[0]), np.arange(1.0, m + 1),
                               rtol=1e-8)
    # residual identity ||A v - lam C v|| small (the Lanczos-step identity;
    # the ultimate attainable residual is limited by the basis-whitening
    # cutoff, eigenvalues converge far beyond it)
    assert float(rn.max()) < 1e-4


def test_lobpcg_cross_validates_dense():
    """LOBPCG vs the dense transform solver on the same pencils — the
    reference's two-solver cross-check (test_eigensolver.cc)."""
    A, C = make_pencils()
    m = 4
    params = EigensolverParams(nev=m, threshold=-1.0)
    lam_d, V_d, _ = solve_gevp_dense(A, C, params)
    rng = np.random.default_rng(2)
    X0 = jnp.asarray(rng.normal(size=(A.shape[0], A.shape[1], m)))
    prec = jnp.linalg.inv(A + 1e-8 * jnp.eye(A.shape[1]))
    lam_l, V_l, rn, _ = lobpcg_gevp(A, C, X0, prec_inv=prec, maxit=120)
    np.testing.assert_allclose(np.asarray(lam_l), np.asarray(lam_d[:, :m]),
                               rtol=1e-6)
    # eigenvector agreement up to sign: |<v_d, C v_l>| ~ C-norms product
    for s in range(A.shape[0]):
        for k in range(m):
            vd = np.asarray(V_d[s, k])
            vl = np.asarray(V_l[s, k])
            Cs = np.asarray(C[s])
            ip = abs(vd @ Cs @ vl) / np.sqrt((vd @ Cs @ vd) * (vl @ Cs @ vl))
            assert ip > 1 - 1e-6, (s, k, ip)


def test_lobpcg_tol_is_live():
    """A loose tolerance must stop earlier than a tight one (the tol
    parameter drives the convergence test, not a fixed-length scan)."""
    A, C = make_pencils()
    rng = np.random.default_rng(4)
    X0 = jnp.asarray(rng.normal(size=(A.shape[0], A.shape[1], 4)))
    prec = jnp.linalg.inv(A + 1e-8 * jnp.eye(A.shape[1]))
    *_, it_loose = lobpcg_gevp(A, C, X0, prec_inv=prec, maxit=500, tol=1e-2)
    *_, it_tight = lobpcg_gevp(A, C, X0, prec_inv=prec, maxit=500, tol=1e-11)
    assert int(it_loose) < int(it_tight) <= 500


def test_dispatch_krylovschur_matches_dense():
    """eigensolver.type=KrylovSchur (the name the reference's poisson.ini:45
    uses) dispatches to the iterative path; eigenvalues must match the dense
    transform — the reference's two-solver cross-check
    (test_eigensolver.cc:230-240)."""
    from ddm_jax.eigen import solve_gevp

    A, C = make_pencils()
    params_d = EigensolverParams(nev=4, threshold=-1.0)
    params_i = EigensolverParams(
        type="KrylovSchur", nev=4, threshold=-1.0, tolerance=1e-10, maxit=400
    )
    lam_d, _, act_d = solve_gevp(A, C, params_d)
    lam_i, _, act_i = solve_gevp(A, C, params_i)
    np.testing.assert_allclose(np.asarray(lam_i), np.asarray(lam_d),
                               rtol=1e-6)
    assert bool(act_i.all()) and bool(act_d.all())
    # indefinite pencils must refuse the iterative path
    with pytest.raises(ValueError, match="SPD"):
        solve_gevp(A, C, params_i, spd=False)


def test_auto_dispatch_picks_by_subdomain_size(monkeypatch):
    """eigensolver.type=auto: dense at/below the crossover,
    LOBPCG above it, dense for non-SPD pencils regardless of size (no
    reference analogue — eigensolvers.hh:14-38 only implements Spectra)."""
    import ddm_jax.eigen as eig

    A, C = make_pencils()  # p = 40
    params = EigensolverParams(
        type="auto", nev=4, threshold=-1.0, tolerance=1e-10, maxit=400
    )
    params_d = EigensolverParams(nev=4, threshold=-1.0)
    lam_auto, _, _ = eig.solve_gevp(A, C, params)
    lam_d, _, _ = eig.solve_gevp(A, C, params_d)
    # below the crossover auto == the dense path, bit-for-bit
    np.testing.assert_array_equal(np.asarray(lam_auto), np.asarray(lam_d))
    # above the crossover auto == the iterative path
    monkeypatch.setattr(eig, "AUTO_CROSSOVER_P", 8)
    lam_i, _, _ = eig.solve_gevp(A, C, params)
    lam_ref, _, _ = eig.solve_gevp(
        A, C, EigensolverParams(type="lobpcg", nev=4, threshold=-1.0,
                                tolerance=1e-10, maxit=400)
    )
    np.testing.assert_array_equal(np.asarray(lam_i), np.asarray(lam_ref))
    # non-SPD pencils stay dense even above the crossover (no ValueError)
    lam_spd, _, _ = eig.solve_gevp(A, C, params, spd=False)
    lam_d_ind, _, _ = eig.solve_gevp(A, C, params_d, spd=False)
    np.testing.assert_array_equal(np.asarray(lam_spd), np.asarray(lam_d_ind))


def test_adaptive_nev_escalation():
    """threshold > 0: the block width doubles until the largest computed
    eigenvalue clears the threshold (spectra.hh:157-189 nev escalation),
    and the active mask keeps exactly the below-threshold prefix."""
    from ddm_jax.eigen.lobpcg import lobpcg_gevp_adaptive

    p = 32
    diag = np.arange(1.0, p + 1)
    A = jnp.asarray(np.stack([np.diag(diag)] * 2))
    C = jnp.asarray(np.stack([np.eye(p)] * 2))
    params = EigensolverParams(
        type="lobpcg", nev=2, blocksize=2, nev_max=8, threshold=6.5,
        tolerance=1e-9, maxit=400,
    )
    lam, V, active = lobpcg_gevp_adaptive(A, C, params)
    assert lam.shape == (2, 8)  # escalated to nev_max
    np.testing.assert_allclose(np.asarray(lam[:, :6]),
                               np.tile(np.arange(1.0, 7), (2, 1)), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(active.sum(axis=1)), [6, 6])


def test_geneo_pipeline_with_iterative_eigensolver():
    """Config-selectable end to end: geneo.eigensolver.type=KrylovSchur runs
    the full two-level pipeline on the islands problem with iteration counts
    matching the dense-eigensolver pipeline."""
    from ddm_jax.api import default_ptree, setup_problem, solve
    from ddm_jax.fem import problems as pm

    def run(es_type):
        pt = default_ptree()
        pt["gridsize"] = 32
        pt["solver.type"] = "restartedgmressolver"
        pt["solver.reduction"] = 1e-8
        pt["coarsespace.type"] = "geneo"
        pt["geneo.eigensolver.type"] = es_type
        pt["geneo.eigensolver.nev"] = 4
        pt["geneo.eigensolver.threshold"] = -1.0
        pt["geneo.eigensolver.tolerance"] = 1e-8
        p = setup_problem(pt, problem=pm.islands(), parts=(2, 2))
        return solve(p)

    res_d = run("spectra")
    res_i = run("KrylovSchur")
    assert bool(res_i.converged)
    assert abs(int(res_i.iterations) - int(res_d.iterations)) <= 1


def test_lobpcg_geneo_pencil():
    """On an actual GenEO pencil (A Neumann, C POU-scaled), LOBPCG must find
    the same smallest eigenvalues as the dense path."""
    import jax

    from ddm_jax.api import default_ptree, setup_problem
    from ddm_jax.coarse.geneo import neumann_matrices
    from ddm_jax.fem import problems as pm
    from ddm_jax.fem.subassembly import scale_matrix_with_pou

    pt = default_ptree()
    pt["gridsize"] = 24
    p = setup_problem(pt, problem=pm.islands(), parts=(2, 2))
    A_neu, B = neumann_matrices(p)
    C = scale_matrix_with_pou(B, jnp.asarray(p.pou))
    reg = 1e-10 * jnp.eye(A_neu.shape[1])
    A_r = A_neu + reg
    params = EigensolverParams(nev=4, threshold=-1.0)
    lam_d, _, _ = solve_gevp_dense(A_r, C, params)
    rng = np.random.default_rng(3)
    X0 = jnp.asarray(rng.normal(size=(A_r.shape[0], A_r.shape[1], 4)))
    prec = jnp.linalg.inv(A_r + 1e-6 * jnp.eye(A_r.shape[1]))
    lam_l, V_l, rn, _ = lobpcg_gevp(A_r, C, X0, prec_inv=prec, maxit=200)
    np.testing.assert_allclose(np.asarray(lam_l), np.asarray(lam_d[:, :4]),
                               rtol=1e-3)


@pytest.mark.slow
def test_auto_crossover_at_real_scale():
    """Run the auto dispatch on REAL GenEO pencils ABOVE the production
    crossover (p > AUTO_CROSSOVER_P = 2048, no monkeypatched threshold):
    the iterative path must engage and the resulting
    coarse space must solve the problem with the same iteration count as
    the dense path."""
    import ddm_jax.eigen as eig
    from ddm_jax.api import default_ptree, setup_problem, solve
    from ddm_jax.fem import problems as pm

    calls = []
    orig = eig.solve_gevp

    def spy(A, C, params, **kw):
        calls.append((A.shape, params.type))
        return orig(A, C, params, **kw)

    def run(es_type):
        pt = default_ptree()
        pt["gridsize"] = 96
        pt["overlap"] = 2
        pt["coarsespace.type"] = "geneo"
        pt["geneo.eigensolver.type"] = es_type
        pt["geneo.eigensolver.nev"] = 4
        pt["geneo.eigensolver.threshold"] = -1.0
        pt["geneo.eigensolver.tolerance"] = 1e-9
        pt["geneo.eigensolver.maxit"] = 400
        p = setup_problem(pt, problem=pm.islands(), parts=(2, 2))
        assert p.topo.n_pad > eig.AUTO_CROSSOVER_P  # genuinely above
        return solve(p)

    import unittest.mock as mock

    # geneo.py does `from ..eigen import solve_gevp` at call time, so
    # patching the eigen module attribute intercepts it
    with mock.patch.object(eig, "solve_gevp", side_effect=spy):
        res_auto = run("auto")
    assert any(t == "auto" for _, t in calls)
    res_dense = run("spectra")
    assert bool(res_auto.converged) and bool(res_dense.converged)
    # the iterative coarse space must be as good as the dense one
    assert abs(int(res_auto.iterations) - int(res_dense.iterations)) <= 1
