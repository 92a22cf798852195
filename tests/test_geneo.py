"""M3: GenEO coarse space — batched GEVP correctness and two-level robustness.

The headline property (the flagship configuration): two-level GenEO-RAS iteration
counts are small and robust to coefficient contrast, where one-level Schwarz
degrades badly on heterogeneous problems.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.linalg

from ddm_jax.api import default_ptree, setup_problem, build_preconditioner, solve
from ddm_jax.config import ParamTree
from ddm_jax.eigen import EigensolverParams, solve_gevp_dense
from ddm_jax.fem import problems as prob
from ddm_jax.fem import structured_grid
from ddm_jax.solvers.krylov import gmres_solve, operator_of, prec_of
from ddm_jax.precond.schwarz import build_schwarz


def test_dense_gevp_matches_scipy():
    rng = np.random.default_rng(0)
    n_sub, p = 3, 24
    A = np.zeros((n_sub, p, p))
    C = np.zeros((n_sub, p, p))
    for s in range(n_sub):
        Q = rng.normal(size=(p, p))
        A[s] = Q @ np.diag(rng.uniform(0.1, 10, p)) @ Q.T
        R = rng.normal(size=(p, p))
        C[s] = R @ R.T
    params = EigensolverParams(nev=5, threshold=-1.0)
    lam, V, active = solve_gevp_dense(jnp.asarray(A), jnp.asarray(C), params)
    for s in range(n_sub):
        w = scipy.linalg.eigh(A[s], C[s], eigvals_only=True)
        w = np.sort(w[np.isfinite(w)])
        np.testing.assert_allclose(np.asarray(lam[s]), w[:5], rtol=1e-5)
        # eigenvector residuals ||A v - lam C v||
        for k in range(5):
            v = np.asarray(V[s, k])
            r = A[s] @ v - float(lam[s, k]) * (C[s] @ v)
            assert np.linalg.norm(r) < 1e-5 * np.linalg.norm(A[s] @ v)


@pytest.mark.parametrize("seed_mode", ["eigh", "subspace"])
def test_dense_gevp_f32_path_resolves_wide_spectrum(seed_mode):
    """The mixed-precision (downcast) path on a pencil whose mu = 1/lambda
    spans 12 decades — the ring-pencil regime where the f32 seed and the
    refinement noise floor buried the mid-spectrum until the reg floor +
    buffered refinement landed (384^2/256 geneo_ring stalled at 400 GMRES
    iterations; scratch/gevp_refine_r3.py).  Kept eigenvalues above the
    1e-6 shift floor must match the exact 1/mu to 1e-3."""
    rng = np.random.default_rng(3)
    p, m = 96, 8
    L = np.tril(rng.normal(size=(p, p))) + 4.0 * np.eye(p)
    A = L @ L.T
    # exact GEVP spectrum: lam = 1/mu, mu from 1e11 down (one near-null
    # C-complement mode, one small mode near the shift floor, then a
    # geometrically separated tail as in the real GenEO pencils)
    mu = np.concatenate([[1e11, 1e4], np.geomspace(50.0, 1e-4, p - 2)])
    W = np.linalg.qr(rng.normal(size=(p, p)))[0]
    C = L @ (W * mu) @ W.T @ L.T
    C = 0.5 * (C + C.T)
    params = EigensolverParams(
        nev=m, threshold=-1.0, precision="f32", seed_mode=seed_mode
    )
    lam, V, active = solve_gevp_dense(
        jnp.asarray(A)[None], jnp.asarray(C)[None], params
    )
    lam = np.asarray(lam[0])
    lam_true = np.sort(1.0 / mu)[:m]
    # the 1e-11 and 1e-4 modes read at/near the shift floor but stay the
    # smallest (selected) pair
    assert lam[0] < 5e-3 and lam[1] < 5e-3
    sel = lam_true > 5e-3  # the smooth tail, clear of the shift floor
    # pre-fix these came out O(1)-9x wrong (see scratch/gevp_refine_r3.py);
    # 3e-2 cleanly pins the fixed behavior (the block-edge pair converges
    # slowest — ~1.7e-2 on this synthetic)
    np.testing.assert_allclose(lam[sel], lam_true[sel], rtol=3e-2)


def test_staged_whitener_matches_chol_and_f64():
    """The mixed-precision staged whitener (solvers/direct.py:
    staged_whiten_batched + the whitened-metric Rayleigh-Ritz in
    dense_gevp.py) must reproduce the f64-Cholesky whitener's eigenpairs on
    near-singular high-contrast pencils — the ring-pencil regime (cond
    1e9+) where a plain f32 Cholesky whitener fails outright (CLAUDE.md
    failed experiments) and staging is what makes f32 recurrences safe."""
    rng = np.random.default_rng(7)
    n_sub, p, m = 5, 96, 6
    As, Cs = [], []
    for s in range(n_sub):
        Q = np.linalg.qr(rng.standard_normal((p, p)))[0]
        d = 10.0 ** rng.uniform(-9, 0, size=p)
        d[:3] = 1e-12  # near-kernel block (Neumann-like)
        A = (Q * d) @ Q.T
        w = np.zeros(p)
        w[: p // 3] = rng.uniform(0.5, 1.0, p // 3)  # thin support (ring)
        C = (A * w[None, :] * w[:, None]) + 1e-8 * np.eye(p)
        As.append(0.5 * (A + A.T))
        Cs.append(0.5 * (C + C.T))
    A = jnp.asarray(np.stack(As))
    C = jnp.asarray(np.stack(Cs))
    from dataclasses import replace

    from ddm_jax.eigen import solve_gevp_dense_auto, solve_gevp_dense_jit

    params = EigensolverParams(
        nev=m, threshold=-1.0, precision="f32", refine_iters=4, refine_buf=24
    )
    lam_s, V_s, _ = solve_gevp_dense_auto(A, C, replace(params, whiten="staged"))
    lam_r, V_r, _ = solve_gevp_dense_jit(A, C, replace(params, precision="f64"))
    np.testing.assert_allclose(
        np.asarray(lam_s), np.asarray(lam_r), rtol=1e-3
    )
    for s in range(n_sub):
        W1 = np.linalg.qr(np.asarray(V_s[s]).T)[0]
        W2 = np.linalg.qr(np.asarray(V_r[s]).T)[0]
        sv = np.linalg.svd(W1.T @ W2, compute_uv=False)
        assert sv.min() > 1.0 - 1e-6  # kept spans coincide


def test_staged_whitener_fallback_on_f32_failure():
    """A subdomain whose f32 Cholesky cannot succeed (eigenvalues below
    f32's representable spread) must come back through the shift-escalation
    / exact-f64 fallback with the SAME whitening guarantee Aw = M A M^T
    = I + E, ||E||_F <= rtol."""
    from ddm_jax.solvers.direct import staged_whiten_batched

    rng = np.random.default_rng(11)
    p = 64
    mats = []
    for dmin in (1e-2, 1e-10, 1e-7):  # benign, f32-hopeless, borderline
        Q = np.linalg.qr(rng.standard_normal((p, p)))[0]
        d = np.geomspace(1.0, dmin, p)
        mats.append((Q * d) @ Q.T)
    A = jnp.asarray(np.stack([0.5 * (M + M.T) for M in mats]))
    M, Aw, resid = staged_whiten_batched(A, rtol=1e-3)
    assert np.asarray(resid).max() < 1e-3
    Aw2 = np.einsum("spq,sqr,str->spt", np.asarray(M), np.asarray(A),
                    np.asarray(M))
    E = Aw2 - np.eye(p)[None]
    assert np.sqrt((E * E).sum((1, 2))).max() < 1e-3
    np.testing.assert_allclose(np.asarray(Aw), Aw2, atol=1e-4)


def test_gevp_threshold_selection():
    # diagonal pencil: A = diag(1..p), C = I -> lambda = 1..p
    p = 16
    A = jnp.asarray(np.diag(np.arange(1.0, p + 1))[None])
    C = jnp.asarray(np.eye(p)[None])
    params = EigensolverParams(nev=4, nev_max=12, threshold=6.5)
    lam, V, active = solve_gevp_dense(A, C, params)
    # kept: lambda in {1..6} (< 6.5)
    assert int(active[0].sum()) == 6
    np.testing.assert_allclose(np.asarray(lam[0][:6]), np.arange(1.0, 7.0), rtol=1e-10)


def geneo_ptree(nev=8, threshold=-1.0):
    pt = default_ptree()
    pt["gridsize"] = 64
    pt["overlap"] = 2
    pt["solver.reduction"] = 1e-8
    pt["coarsespace.type"] = "geneo"
    pt["coarse_solver.type"] = "cholesky"
    pt["geneo.eigensolver.nev"] = nev
    pt["geneo.eigensolver.threshold"] = threshold
    return pt


def test_geneo_two_level_beats_one_level_on_islands():
    pt = geneo_ptree(nev=8)
    p = setup_problem(pt, problem=prob.islands(), parts=(4, 4))
    fine = build_schwarz(p.A, p.topo, p.pou, pt)
    r1 = gmres_solve(operator_of(p.A), prec_of(fine), p.rhs,
                     jnp.zeros_like(p.rhs), reduction=1e-8, maxit=400,
                     restart=50)
    prec = build_preconditioner(p)
    r2 = gmres_solve(operator_of(p.A), prec_of(prec), p.rhs,
                     jnp.zeros_like(p.rhs), reduction=1e-8, maxit=400,
                     restart=50)
    assert bool(r2.converged)
    assert int(r2.iterations) < int(r1.iterations) / 2, (
        int(r1.iterations), int(r2.iterations))
    assert int(r2.iterations) <= 30


def test_geneo_contrast_robustness():
    """GenEO iteration counts must be (nearly) contrast-independent."""
    iters = {}
    for contrast in (1e2, 1e6):
        def alpha(xq, c=contrast):
            ix = jnp.floor(xq[..., 0] * 8).astype(jnp.int32)
            iy = jnp.floor(xq[..., 1] * 8).astype(jnp.int32)
            return jnp.where(ix % 2 == iy % 2, c, 1.0)

        problem = prob.Problem(alpha=alpha, f=lambda x: jnp.ones(x.shape[:-1]))
        pt = geneo_ptree(nev=10)
        p = setup_problem(pt, problem=problem, parts=(4, 4))
        prec = build_preconditioner(p)
        r = gmres_solve(operator_of(p.A), prec_of(prec), p.rhs,
                        jnp.zeros_like(p.rhs), reduction=1e-8, maxit=400,
                        restart=50)
        assert bool(r.converged)
        iters[contrast] = int(r.iterations)
    assert iters[1e6] <= iters[1e2] + 6, iters


def test_geneo_adaptive_threshold():
    pt = geneo_ptree(nev=4, threshold=0.3)
    pt["geneo.eigensolver.nev_max"] = 16
    p = setup_problem(pt, problem=prob.islands(), parts=(4, 4))
    from ddm_jax.coarse.geneo import geneo_coarse_space

    basis = geneo_coarse_space(p, pt)
    counts = np.asarray(basis.active.sum(axis=1))
    assert (counts >= 1).all() and (counts <= 16).all()
    # heterogeneous subdomains need differing numbers of vectors
    assert counts.min() != counts.max()


def test_geneo_3d():
    pt = geneo_ptree(nev=6)
    pt["gridsize"] = 12
    grid = structured_grid((12, 12, 12))
    p = setup_problem(pt, problem=prob.simple(), grid=grid, parts=(2, 2, 2))
    prec = build_preconditioner(p)
    r = gmres_solve(operator_of(p.A), prec_of(prec), p.rhs,
                    jnp.zeros_like(p.rhs), reduction=1e-8, maxit=200,
                    restart=50)
    assert bool(r.converged)
    assert int(r.iterations) <= 25


def test_algebraic_geneo():
    pt = geneo_ptree(nev=8)
    pt["coarsespace.type"] = "algebraic_geneo"
    pt["algebraic_geneo.eigensolver.nev"] = 8
    p = setup_problem(pt, problem=prob.islands(), parts=(4, 4))
    prec = build_preconditioner(p)
    r = gmres_solve(operator_of(p.A), prec_of(prec), p.rhs,
                    jnp.zeros_like(p.rhs), reduction=1e-8, maxit=400,
                    restart=50)
    assert bool(r.converged)
    assert int(r.iterations) <= 60


def test_probe_whitener_thin_metric_matches_batched():
    """Round-5 probe-accepted stage-0 whitener (staged_whiten_estimate +
    the thin Rayleigh-Ritz metric): on moderate-cond pencils where the
    stage-0 residual meets WHITEN_RTOL, the Aw-free path must reproduce the
    Aw-forming staged path's eigenpairs."""
    import os
    from dataclasses import replace

    from ddm_jax.eigen import solve_gevp_dense_auto
    from ddm_jax.solvers.direct import staged_whiten_estimate

    rng = np.random.default_rng(11)
    n_sub, p, m = 4, 96, 6
    As, Cs = [], []
    for s in range(n_sub):
        Q = np.linalg.qr(rng.standard_normal((p, p)))[0]
        d = 10.0 ** rng.uniform(-4, 0, size=p)  # cond ~ 1e4: stage-0 accepts
        A = (Q * d) @ Q.T
        w = rng.uniform(0.3, 1.0, p)
        C = (A * w[None, :] * w[:, None]) + 1e-8 * np.eye(p)
        As.append(0.5 * (A + A.T))
        Cs.append(0.5 * (C + C.T))
    A = jnp.asarray(np.stack(As))
    C = jnp.asarray(np.stack(Cs))
    params = EigensolverParams(
        nev=m, threshold=-1.0, precision="f32", refine_iters=4,
        refine_buf=24, whiten="staged",
    )
    # the probe must actually accept at this conditioning
    from ddm_jax.eigen.dense_gevp import _prep_jit
    Areg = _prep_jit()(A, C, params.shift, 1e-12)
    M, Aw, r = staged_whiten_estimate(Areg)
    assert Aw is None, f"probe should accept stage-0 here (resid {r})"

    lam_thin, V_thin, _ = solve_gevp_dense_auto(A, C, params)
    os.environ["DDM_WHITEN_PROBE"] = "0"
    try:
        lam_b, V_b, _ = solve_gevp_dense_auto(A, C, params)
    finally:
        os.environ.pop("DDM_WHITEN_PROBE")
    np.testing.assert_allclose(
        np.asarray(lam_thin), np.asarray(lam_b), rtol=1e-6
    )
    for s in range(n_sub):
        W1 = np.linalg.qr(np.asarray(V_thin[s]).T)[0]
        W2 = np.linalg.qr(np.asarray(V_b[s]).T)[0]
        sv = np.linalg.svd(W1.T @ W2, compute_uv=False)
        assert sv.min() > 1.0 - 1e-6
