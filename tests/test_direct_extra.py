"""Extra coverage of solvers/direct.py building blocks."""

import jax.numpy as jnp
import numpy as np
import pytest

from ddm_jax.solvers.direct import batched_tri_lower_inv, factor_batched


@pytest.mark.parametrize("p", [100, 128, 300])
def test_batched_tri_lower_inv_matches_numpy(p):
    """Blocked-substitution triangular inverse == numpy inv, including the
    non-multiple-of-block padding path (the accelerator factorise/GEVP
    path; solvers/direct.py:batched_tri_lower_inv)."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((3, p, p))
    A = A @ np.swapaxes(A, 1, 2) + p * np.eye(p)
    L = np.linalg.cholesky(A)
    Li = np.asarray(batched_tri_lower_inv(jnp.asarray(L)))
    ref = np.linalg.inv(L)
    assert np.abs(Li - ref).max() / np.abs(ref).max() < 1e-13


def test_batched_tri_lower_inv_small_block():
    """Explicit small block size exercises multi-block substitution."""
    rng = np.random.default_rng(1)
    p = 70
    A = rng.standard_normal((2, p, p))
    A = A @ np.swapaxes(A, 1, 2) + p * np.eye(p)
    L = np.linalg.cholesky(A)
    Li = np.asarray(batched_tri_lower_inv(jnp.asarray(L), nb=16))
    ref = np.linalg.inv(L)
    assert np.abs(Li - ref).max() / np.abs(ref).max() < 1e-13


def test_factor_batched_inverse_quality_without_polish():
    """mode=inverse with refine_steps=0 (the new default) still produces an
    inverse whose solve error is at the eps*cond level (the Newton polish
    measured no better on either backend)."""
    rng = np.random.default_rng(2)
    p = 120
    A = rng.standard_normal((4, p, p))
    A = A @ np.swapaxes(A, 1, 2) + 1e-3 * p * np.eye(p)
    Aj = jnp.asarray(A)
    fac = factor_batched(Aj, "cholesky", mode="inverse", refine_steps=0)
    x = jnp.asarray(rng.standard_normal((4, p)))
    b = jnp.einsum("spq,sq->sp", Aj, x)
    xs = fac.solve(b)
    err = float(jnp.linalg.norm(xs - x) / jnp.linalg.norm(x))
    assert err < 1e-8


@pytest.mark.parametrize("p", [100, 128, 300])
def test_batched_cholesky_blocked_matches_numpy(p):
    """Blocked Cholesky == LAPACK Cholesky to roundoff, incl. padding and
    an ill-conditioned diagonal scaling."""
    rng = np.random.default_rng(3)
    from ddm_jax.solvers.direct import batched_cholesky_blocked

    d = 10.0 ** rng.uniform(-3, 3, p)
    A = rng.standard_normal((3, p, p))
    A = A @ np.swapaxes(A, 1, 2) + p * np.eye(p)
    A = d[None, :, None] * A * d[None, None, :]
    L = np.asarray(batched_cholesky_blocked(jnp.asarray(A)))
    ref = np.linalg.cholesky(A)
    assert np.abs(L - ref).max() / np.abs(ref).max() < 1e-13


def test_cholesky_batched_chunking_matches_unchunked():
    """One unchunked batched Cholesky at batch 200 — no batch cap on any
    backend — equals the per-matrix factors."""
    rng = np.random.default_rng(11)
    A = rng.standard_normal((200, 13, 13))
    A = A @ np.swapaxes(A, 1, 2) + 13 * np.eye(13)
    fac = factor_batched(jnp.asarray(A), "cholesky", mode="factors")
    L = np.asarray(fac.chol)
    ref = np.linalg.cholesky(A)
    assert np.abs(L - ref).max() / np.abs(ref).max() < 1e-13


@pytest.mark.parametrize("name", ["lu", "umfpack", "superlu", "strumpack"])
def test_lu_names_factor_by_lu_on_every_backend(name):
    """The reference's LU solver names mean partial-pivoting LU everywhere,
    and a nonsymmetric batch solves through it."""
    from ddm_jax.solvers.direct import BatchedLU, resolve_solver_type

    assert resolve_solver_type(name) == "lu"
    rng = np.random.default_rng(12)
    A = rng.standard_normal((5, 17, 17)) + 17 * np.eye(17)
    x = rng.standard_normal((5, 17))
    b = np.einsum("spq,sq->sp", A, x)
    fac = factor_batched(jnp.asarray(A), name)
    assert isinstance(fac, BatchedLU)
    xs = np.asarray(fac.solve(jnp.asarray(b)))
    assert np.abs(xs - x).max() / np.abs(x).max() < 1e-12


def test_newton_inverse_matches_direct():
    """f32-seed + f64 Newton construction reaches the same inverse as the
    direct f64 Cholesky pipeline (solvers/direct.py:newton_inverse_batched),
    including on an ill-conditioned diagonal scaling (the equilibrated
    high-contrast subdomain regime it exists for)."""
    rng = np.random.default_rng(7)
    from ddm_jax.solvers.direct import factor_batched, newton_inverse_batched

    p = 90
    d = 10.0 ** rng.uniform(-2, 2, p)
    A = rng.standard_normal((3, p, p))
    A = A @ np.swapaxes(A, 1, 2) + p * np.eye(p)
    A = d[None, :, None] * A * d[None, None, :]
    Aj = jnp.asarray(A)
    ref = factor_batched(Aj, "cholesky", mode="inverse", refine_steps=0)
    got = newton_inverse_batched(Aj)
    resid = np.linalg.norm(
        np.eye(p) - np.einsum("spq,sqr->spr", A, np.asarray(got.inv)),
        axis=(1, 2),
    ).max()
    assert resid < 1e-9
    x = jnp.asarray(rng.standard_normal((3, p)))
    b = jnp.einsum("spq,sq->sp", Aj, x)
    diff = float(jnp.linalg.norm(got.solve(b) - ref.solve(b))
                 / jnp.linalg.norm(x))
    assert diff < 1e-9


def test_newton_inverse_fallback_is_exact():
    """With max_steps=0 the residual-controlled loop can never accept, so
    the per-chunk exact-f64 fallback must produce the direct pipeline's
    result — the guarantee that the Newton construction NEVER degrades the
    preconditioner when the seed diverges."""
    rng = np.random.default_rng(8)
    from ddm_jax.solvers.direct import factor_batched, newton_inverse_batched

    p = 40
    A = rng.standard_normal((2, p, p))
    A = A @ np.swapaxes(A, 1, 2) + p * np.eye(p)
    Aj = jnp.asarray(A)
    ref = factor_batched(Aj, "cholesky", mode="inverse", refine_steps=0)
    got = newton_inverse_batched(Aj, max_steps=0)
    assert np.allclose(np.asarray(got.inv), np.asarray(ref.inv), rtol=0, atol=0)


def test_newton_inverse_dd_packing():
    """store_dtype='dd' returns the double-single apply container with the
    hi+lo pair reconstructing the f64 inverse to ~2^-48."""
    rng = np.random.default_rng(9)
    from ddm_jax.solvers.direct import BatchedInverseDD, newton_inverse_batched

    p = 50
    A = rng.standard_normal((2, p, p))
    A = A @ np.swapaxes(A, 1, 2) + p * np.eye(p)
    # rtol below what the (r5 f64-product) seed can reach so the Newton
    # refinement provably engages and the dd pair must carry full accuracy
    got = newton_inverse_batched(jnp.asarray(A), store_dtype="dd",
                                 rtol=1e-10)
    assert isinstance(got, BatchedInverseDD)
    inv = np.asarray(got.inv_hi, np.float64) + np.asarray(got.inv_lo, np.float64)
    resid = np.linalg.norm(
        np.eye(p) - np.einsum("spq,sqr->spr", A, inv), axis=(1, 2)
    ).max()
    assert resid < 1e-9


def test_newton_rtol_config_flows_to_factorise(monkeypatch):
    """schwarz.subdomain_solver.newton_rtol must reach
    newton_inverse_batched (precond/schwarz.py factorise dispatch), and a
    PRECONDITIONER-grade loose tolerance must still converge the solve to
    the same reduction: Newton error is multiplicative, X = A^{-1}(I+E),
    so it does not perturb the small-eigenvalue structure the way the
    rejected additive f32 apply path did."""
    import ddm_jax.solvers.direct as direct
    from ddm_jax.api import default_ptree, setup_problem, solve
    from ddm_jax.fem import problems

    seen = {}
    orig = direct.newton_inverse_batched

    def spy(A, store_dtype=None, rtol=None, max_steps=None):
        seen["rtol"] = rtol
        return orig(A, store_dtype=store_dtype, rtol=rtol,
                    max_steps=max_steps)

    monkeypatch.setattr(direct, "newton_inverse_batched", spy)
    pt = default_ptree()
    pt["gridsize"] = 32
    pt["schwarz.subdomain_solver.construction"] = "newton"
    # f32 storage precision forces explicit-inverse mode on the CPU test
    # backend so the newton construction branch is reachable
    pt["schwarz.subdomain_solver.precision"] = "f32"
    pt["schwarz.subdomain_solver.newton_rtol"] = 0.02
    pt["solver.reduction"] = 1e-6
    p = setup_problem(pt, problem=problems.islands(), parts=(2, 2))
    res = solve(p)
    assert seen["rtol"] == pytest.approx(0.02)
    assert res.converged


def test_seed_accept_returns_raw_seed(monkeypatch):
    """DDM_NEWTON_SEED_ACCEPT=1 + rtol above the seed residual must return
    the raw f32 Cholesky seed (bitwise: no Newton step applied), and the
    sampled Hutchinson estimate must be within a small factor of the true
    Frobenius residual (solvers/direct.py:_seed_resid_est)."""
    rng = np.random.default_rng(11)
    from ddm_jax.solvers import direct

    p = 70
    d = 10.0 ** rng.uniform(-2, 2, p)
    A = rng.standard_normal((3, p, p))
    A = A @ np.swapaxes(A, 1, 2) + p * np.eye(p)
    A = d[None, :, None] * A * d[None, None, :]
    Aj = jnp.asarray(A)

    # tier-1 accept (r5) returns the plain f32-product seed, exactly the
    # r3c fast path
    seed = direct._newton_seed_jit()(Aj)
    true_r = np.linalg.norm(
        np.eye(p) - np.einsum("spq,sqr->spr", A, np.asarray(seed)),
        axis=(1, 2),
    ).max()
    est = float(direct._seed_resid_jit()(Aj, seed))
    # Hutchinson with 8 probes: correct order of magnitude is all we need
    assert est == pytest.approx(true_r, rel=0.75) or (
        est < 1e-5 and true_r < 1e-5
    )

    monkeypatch.setenv("DDM_NEWTON_SEED_ACCEPT", "1")
    got = direct.newton_inverse_batched(Aj, rtol=max(10 * est, 1e-4))
    assert np.array_equal(np.asarray(got.inv), np.asarray(seed))

    # with a tolerance below the seed residual the Newton path must engage
    if est > 1e-8:
        got2 = direct.newton_inverse_batched(Aj, rtol=est / 10)
        assert not np.array_equal(np.asarray(got2.inv), np.asarray(seed))


def test_whitened_seed_accept_criterion():
    """r5: preconditioner-grade rtol (>= 1e-2) accepts on the whitened
    residual ||Li A Li^T - I||_F; the estimator must track the true value,
    and a seed whose PLAIN residual exceeds rtol while the whitened one
    meets it must be accepted (the unstructured-audit regime)."""
    from ddm_jax.solvers import direct

    rng = np.random.default_rng(5)
    p = 80
    # strong diagonal scaling: plain ||AX - I|| inflated by cond(Li), the
    # whitened residual stays ~ f32-factor class
    d = 10.0 ** np.linspace(-3.5, 0, p)
    B = rng.standard_normal((2, p, p))
    A = B @ np.swapaxes(B, 1, 2) + p * np.eye(p)
    A = d[None, :, None] * A * d[None, None, :]
    Aj = jnp.asarray(A)
    X, Li = direct._newton_seed_jit()(Aj, with_factor=True)
    rw_est = float(direct._whitened_seed_resid_jit()(Aj, Li))
    Lin = np.asarray(Li)
    W = np.einsum("spq,sqr,str->spt", Lin, A, Lin) - np.eye(p)
    rw_true = np.linalg.norm(W, axis=(1, 2)).max()
    assert rw_est == pytest.approx(rw_true, rel=0.75) or (
        rw_est < 1e-5 and rw_true < 1e-5
    )
    r_plain = float(direct._seed_resid_jit()(Aj, X))
    assert rw_true <= r_plain * 1.0001  # whitened is the tighter measure
    if rw_true < 0.4:
        # the returned inverse (tier-1 f32-product seed or the escalated
        # f64-product seed, whichever accepted) must meet the spectral
        # contract sigma(I - X A) < rtol
        got = direct.newton_inverse_batched(Aj, rtol=0.4)
        E = np.eye(A.shape[-1])[None] - np.einsum(
            "spq,sqr->spr", np.asarray(got.inv), A)
        rho = max(np.abs(np.linalg.eigvals(E[s])).max()
                  for s in range(A.shape[0]))
        assert rho < 0.4, rho


def test_a_inner_product_sigma_estimator():
    """_plain_sigma_est must read the SPECTRAL RADIUS of E = I - XA, not
    its (cond-inflated) nonnormal 2-norm: built here with a known spectrum
    and strong diagonal scaling, the 2-norm is orders of magnitude above
    the spectral radius."""
    from ddm_jax.solvers import direct

    rng = np.random.default_rng(3)
    p = 60
    d = 10.0 ** np.linspace(-3, 0, p)
    B = rng.standard_normal((2, p, p))
    A = B @ np.swapaxes(B, 1, 2) + p * np.eye(p)
    A = d[None, :, None] * A * d[None, None, :]
    # X = A^{-1} (I + E) with a small SYMMETRIC-in-A perturbation:
    # X = A^-1 + s * A^-1 S A^-1-ish; simplest: X = Ainv @ (I + P) with
    # P = V diag(mu) V^{-1} built A-self-adjointly via a congruence
    Ainv = np.linalg.inv(A)
    rho_true = 0.0
    Xs = []
    for s in range(2):
        M = rng.standard_normal((p, p)) * 0.05
        S = 0.5 * (M + M.T)  # symmetric -> A^{-1}S is A-self-adjoint... use
        X = Ainv[s] + Ainv[s] @ S @ Ainv[s]
        E = np.eye(p) - X @ A[s]
        rho_true = max(rho_true, np.abs(np.linalg.eigvals(E)).max())
        Xs.append(X)
    X = jnp.asarray(np.stack(Xs))
    est = float(direct._plain_sigma_jit()(jnp.asarray(A), X))
    two_norm = max(
        np.linalg.norm(np.eye(p) - np.asarray(X[s]) @ A[s], 2)
        for s in range(2)
    )
    # the estimator must track the spectral radius, not the 2-norm
    assert est == pytest.approx(rho_true, rel=0.3), (est, rho_true, two_norm)
    if two_norm > 10 * rho_true:
        assert est < two_norm / 5
