"""Batched LOBPCG for generalized eigenproblems.

The reference's own dev tree contains a block Lanczos / Krylov-Schur
eigensolver subsystem whose headers are missing from the snapshot
(SURVEY.md caveats: blockmultivector.hh, subspace_iteration.hh, ...,
"KrylovSchur" referenced by examples/poisson.ini:45); its survivors
(DenseSquareBlockMatrix, the SIMD UMFPackMultivecSolver) show the intent:
*blocked* iteration with multi-vector kernels.  Batched, the natural
incarnation is **LOBPCG over the whole subdomain batch at once**: every
operation is a batched tall-skinny matmul and a small dense
Rayleigh-Ritz eigh — this module provides it as the iterative alternative to
the full dense transform (dense_gevp.py) for subdomains too large to eigh.

Solves A v = lambda C v for the ``m`` smallest finite lambda, batched over
(n_sub, p, p) pencils, preconditioned with an (approximate) inverse of A
(the Schwarz subdomain factorization is the natural choice — exactly how the
reference reuses its subdomain factorizations in eigensolves).

:func:`lobpcg_gevp_adaptive` adds the reference's production wrapper
(spectra.hh:111-215): a seeded deterministic start block, an automatic
A-inverse preconditioner, convergence at ``params.tolerance``, and the
adaptive nev-doubling escalation against ``params.threshold``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .params import EigensolverParams


def _rayleigh_ritz(S, C, A, m, eps):
    """Rayleigh-Ritz on the (batched) trial space S (n_sub, p, k) for the
    REVERSED pencil C x = mu A x: returns (mu (n_sub, k), coeff
    (n_sub, k, k)) sorted ascending (the LARGEST mu are the GenEO targets),
    with A-orthonormalization of the basis built in.

    Whitening runs against G = S^T A S with A the REGULARIZED SPD Neumann
    matrix — always well conditioned on the trial space.  (The previous
    formulation whitened against C, which is PSD-singular for GenEO — zero
    outside the POU-scaled overlap — and with a double-single f64 the
    iteration drifted into C's nullspace and returned garbage 0-eigenpairs;
    the dense path's congruence transform factors A for exactly this
    reason, dense_gevp.py.)"""
    G = jnp.einsum("spk,spq,sql->skl", S, A, S)
    H = jnp.einsum("spk,spq,sql->skl", S, C, S)
    G = 0.5 * (G + jnp.swapaxes(G, 1, 2))
    # regularize: a double-single f64 eigh returned NaN eigenvalues on Gram
    # matrices with a degenerate cluster of exact zeros (the initial zero-P
    # block + A-null trial directions produce exactly that; measured); a
    # relative diagonal shift breaks the cluster without moving the
    # drop/keep decision (cut at 1e-12 relative, shift at 1e-14)
    gscale = jnp.maximum(
        jnp.max(jnp.abs(jnp.diagonal(G, axis1=1, axis2=2)), axis=1), eps
    )
    G = G + (1e-14 * gscale)[:, None, None] * jnp.eye(
        G.shape[-1], dtype=G.dtype
    )[None]
    # whiten against G; drop near-null trial directions, NaN-robust (any
    # residual NaN from eigh must not poison the max / the mask)
    w, Q = jnp.linalg.eigh(G)
    w = jnp.where(jnp.isfinite(w), w, 0.0)
    Q = jnp.where(jnp.isfinite(Q), Q, 0.0)
    good = w > jnp.maximum(jnp.max(w, axis=1, keepdims=True), eps) * 1e-12
    W = jnp.where(good[:, None, :], Q / jnp.sqrt(jnp.maximum(w, eps))[:, None, :], 0.0)
    Hw = jnp.einsum("skl,skm,sln->smn", H, W, W)
    # dropped directions have zero rows/cols in Hw (W zeroes them) and
    # appear as mu = 0 eigenvalues, which sort to the BOTTOM of the
    # ascending order — the top-m selection never sees them.  (An explicit
    # +-1e30 diagonal mask was tried instead and destabilized a
    # double-single f64 eigh: individual subdomains' blocks collapsed to
    # zero.)
    mu, Z = jnp.linalg.eigh(0.5 * (Hw + jnp.swapaxes(Hw, 1, 2)))
    mu = jnp.where(jnp.isfinite(mu), mu, 0.0)
    Z = jnp.where(jnp.isfinite(Z), Z, 0.0)
    coeff = jnp.einsum("skl,sln->skn", W, Z)
    return mu, coeff


@partial(jax.jit, static_argnames=("m", "maxit"))
def lobpcg_gevp(
    A: jnp.ndarray,
    C: jnp.ndarray,
    X0: jnp.ndarray,
    prec_inv: jnp.ndarray | None = None,
    m: int | None = None,
    maxit: int = 50,
    tol: float = 1e-6,
):
    """Batched LOBPCG.

    A, C: (n_sub, p, p); X0: (n_sub, p, m) initial block; prec_inv: optional
    (n_sub, p, p) preconditioner (approximate A^{-1}).
    Returns (lam (n_sub, m), V (n_sub, m, p), residual norms (n_sub, m),
    iterations taken).

    Convergence: stops when every block vector in every subdomain satisfies
    ||C x - mu A x|| <= tol * (||C x|| + |mu| ||A x||), or at maxit — the
    batched analogue of the reference's per-vector Lanczos convergence test
    (Spectra compute(), spectra.hh:127-129).

    Pencil orientation: the iteration runs on the REVERSED pencil
    C x = mu A x (mu = 1/lambda, LARGEST mu == the GenEO targets) with the
    regularized-SPD A as the inner-product matrix — C is PSD-singular for
    GenEO (zero off the overlap) and cannot serve as the B-matrix; with C
    as the metric the iteration drifts into C's nullspace (measured:
    garbage 0-eigenpairs with a double-single f64 at bench scale).  This mirrors
    the shift-invert orientation of the reference (spectra.hh:130-138:
    largest of the shifted problem == smallest of the original).
    """
    n_sub, p, _ = A.shape
    if m is None:
        m = X0.shape[-1]
    eps = jnp.asarray(1e-12 if A.dtype == jnp.float64 else 1e-6, A.dtype)
    tol_a = jnp.asarray(tol, A.dtype)
    # regularize A exactly like the dense path (dense_gevp.py): keeps the
    # inner-product matrix SPD on floating (Neumann-singular) subdomains
    scale = jnp.mean(jnp.abs(jnp.diagonal(A, axis1=1, axis2=2)), axis=1)
    A = A + (1e-12 * jnp.maximum(scale, 1.0))[:, None, None] * jnp.eye(
        p, dtype=A.dtype
    )[None]

    def mu_of(X, AX, CX):
        return jnp.einsum("spk,spk->sk", X, CX) / jnp.maximum(
            jnp.einsum("spk,spk->sk", X, AX), eps
        )

    def _quality(mu):
        # per-SUBDOMAIN progress measure (collapse strikes individual
        # subdomains; a global measure lets the improving majority mask
        # them): log1p tracks the decades climbed by the LARGE ritz values
        # (the GenEO targets mu = 1/lambda) while ignoring the noisy
        # fluctuation of the small ones (a plain log-sum stalls on them
        # immediately; a plain sum only sees the single largest)
        return jnp.sum(jnp.log1p(jnp.maximum(mu, 0.0)), axis=1)  # (n_sub,)

    def cond(carry):
        X, P, it, maxres, Xb, qb, stall = carry
        # stall guard: LOBPCG without soft locking DEGRADES when iterated
        # past convergence (measured with a double-single f64: exact
        # eigenvalues at it=3, drift at it=25, total collapse by it=1000);
        # stop when every subdomain has gone 3 iterations without improving
        # and return each subdomain's best iterate
        return (it < maxit) & (maxres > tol_a) & jnp.any(stall < 3)

    def body(carry):
        X, P, it, _, Xb, qb, stall = carry
        AX = jnp.einsum("spq,sqk->spk", A, X)
        CX = jnp.einsum("spq,sqk->spk", C, X)
        mu = mu_of(X, AX, CX)
        q = _quality(mu)  # (n_sub,)
        better = q > qb
        Xb = jnp.where(better[:, None, None], X, Xb)
        qb = jnp.maximum(q, qb)
        stall = jnp.where(better, 0, stall + 1)
        R = CX - mu[:, None, :] * AX
        # relative residual per block vector
        rn = jnp.sqrt(jnp.einsum("spk,spk->sk", R, R))
        denom = jnp.sqrt(jnp.einsum("spk,spk->sk", CX, CX)) + jnp.abs(
            mu
        ) * jnp.sqrt(jnp.einsum("spk,spk->sk", AX, AX))
        maxres = jnp.max(rn / jnp.maximum(denom, eps))
        if prec_inv is not None:
            Wd = jnp.einsum("spq,sqk->spk", prec_inv, R)
        else:
            Wd = R
        # column-normalize the preconditioned residuals: on floating
        # (Neumann-singular) subdomains prec ~ A_reg^{-1} amplifies the
        # near-null component to ~1/reg (1e12), giving the Gram matrix a
        # ~1e24 dynamic range that a double-single f64 eigh cannot
        # resolve — the whitening then drops every direction and the block
        # collapses to zero (measured; LAPACK f64 survives it on CPU).
        Wd = Wd / jnp.maximum(
            jnp.sqrt(jnp.einsum("spk,spk->sk", Wd, Wd)), eps
        )[:, None, :]
        S = jnp.concatenate([X, Wd, P], axis=2)  # (n_sub, p, 3m)
        th, coeff = _rayleigh_ritz(S, C, A, m, eps)
        Cm = coeff[:, :, -m:][:, :, ::-1]  # largest m of the reversed pencil
        Xn = jnp.einsum("spk,skn->spn", S, Cm)
        # implicit P: the W/P part of the update
        Cp = Cm.at[:, :m, :].set(0.0)
        Pn = jnp.einsum("spk,skn->spn", S, Cp)
        # normalize
        Xn = Xn / jnp.maximum(
            jnp.sqrt(jnp.einsum("spk,spk->sk", Xn, Xn)), eps
        )[:, None, :]
        nrm = jnp.sqrt(jnp.einsum("spk,spk->sk", Pn, Pn))
        Pn = Pn / jnp.maximum(nrm, 1.0)[:, None, :]
        return (Xn, Pn, it + 1, maxres, Xb, qb, stall)

    P0 = jnp.zeros_like(X0)
    big = jnp.asarray(jnp.inf, A.dtype)
    neg = jnp.full((n_sub,), -jnp.inf, A.dtype)
    X, P, it, _, Xb, qb, _ = jax.lax.while_loop(
        cond, body,
        (X0, P0, jnp.int32(0), big, X0, neg, jnp.zeros((n_sub,), jnp.int32)),
    )

    # final ritz data, per subdomain, from whichever iterate measured best
    # (the loop's last X is unevaluated and may be past the ds-f64
    # stability point)
    def ritz(Xc):
        AX = jnp.einsum("spq,sqk->spk", A, Xc)
        CX = jnp.einsum("spq,sqk->spk", C, Xc)
        return mu_of(Xc, AX, CX), AX, CX

    mu_l, AX_l, CX_l = ritz(X)
    mu_b, AX_b, CX_b = ritz(Xb)
    use_last = _quality(mu_l) >= _quality(mu_b)  # (n_sub,)
    X = jnp.where(use_last[:, None, None], X, Xb)
    mu = jnp.where(use_last[:, None], mu_l, mu_b)
    AX = jnp.where(use_last[:, None, None], AX_l, AX_b)
    CX = jnp.where(use_last[:, None, None], CX_l, CX_b)
    R = CX - mu[:, None, :] * AX
    rn = jnp.sqrt(jnp.einsum("spk,spk->sk", R, R))
    # back to GenEO orientation: lambda = 1/mu, ascending == mu descending;
    # mu <= floor (C-null trial directions) maps to lambda = +inf (inactive)
    lam = jnp.where(mu > eps, 1.0 / jnp.maximum(mu, eps), jnp.inf)
    order = jnp.argsort(lam, axis=1)
    lam = jnp.take_along_axis(lam, order, axis=1)
    rn = jnp.take_along_axis(rn, order, axis=1)
    X = jnp.take_along_axis(X, order[:, None, :], axis=2)
    return lam, X.transpose(0, 2, 1), rn, it


def _default_prec(A: jnp.ndarray) -> jnp.ndarray:
    """Regularized explicit A-inverse: the batched analogue of the
    reference's reuse of the UMFPACK subdomain factorization inside the
    eigensolve (spectra.hh:42-62)."""
    from ..solvers.direct import factor_batched

    p = A.shape[-1]
    scale = jnp.mean(jnp.abs(jnp.diagonal(A, axis1=1, axis2=2)), axis=1)
    eps = 1e-10 * jnp.maximum(scale, 1.0)
    Areg = A + eps[:, None, None] * jnp.eye(p, dtype=A.dtype)[None]
    fac = factor_batched(Areg, "cholesky", mode="inverse", refine_steps=0)
    return fac.inv


def lobpcg_gevp_adaptive(
    A: jnp.ndarray,
    C: jnp.ndarray,
    params: EigensolverParams,
    prec_inv: jnp.ndarray | None = None,
):
    """Production LOBPCG wrapper with the reference's adaptive selection
    (spectra_gevp_op, spectra.hh:111-215).

    * deterministic start block seeded by ``params.seed``;
    * block width starts at max(nev, blocksize); with ``threshold > 0``, if
      any subdomain's largest computed eigenvalue still lies below the
      threshold — meaning eigenpairs below the threshold may have been
      missed — the width doubles (nev *= 2, spectra.hh:185) up to
      ``nev_max`` and the solve repeats;
    * returns (lam, V, active) in the same static (n_sub, params.max_kept)
      layout as :func:`..dense_gevp.solve_gevp_dense`, with the same
      threshold-prefix selection, so the two are drop-in interchangeable.
    """
    n_sub, p, _ = A.shape
    m_out = min(params.max_kept, p)
    if prec_inv is None:
        prec_inv = _default_prec(A)
    key = jax.random.PRNGKey(params.seed)

    m = min(max(params.nev, params.blocksize), p, m_out)
    while True:
        X0 = jax.random.normal(key, (n_sub, p, m), A.dtype)
        lam, V, rn, _ = lobpcg_gevp(
            A, C, X0, prec_inv=prec_inv, maxit=params.maxit,
            tol=params.tolerance,
        )
        if params.threshold <= 0 or m >= m_out:
            break
        if bool((lam[:, -1] >= params.threshold).all()):
            break
        m = min(2 * m, m_out)  # nev doubling (spectra.hh:185)

    # pad to the static output width
    if m < m_out:
        lam = jnp.concatenate(
            [lam, jnp.full((n_sub, m_out - m), jnp.inf, lam.dtype)], axis=1
        )
        V = jnp.concatenate(
            [V, jnp.zeros((n_sub, m_out - m, p), V.dtype)], axis=1
        )
    # threshold-prefix selection, mirroring dense_gevp.solve_gevp_dense
    if params.threshold > 0:
        keep = lam < params.threshold
        keep = keep.at[:, 0].set(True)  # at least one (spectra.hh:162)
        keep = jnp.cumprod(keep.astype(jnp.int32), axis=1).astype(bool)
    else:
        keep = jnp.ones((n_sub, m_out), bool)
    keep = keep & jnp.isfinite(lam)
    keep = keep.at[:, 0].set(keep[:, 0] | (params.threshold <= 0))
    return lam, V, keep
