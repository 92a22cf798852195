"""Batched dense generalized eigensolver for GenEO-type problems.

Replaces the reference's per-subdomain Spectra shift-invert Lanczos
(dune/ddm/eigensolvers/spectra.hh:28-256): where each MPI rank sequentially
factors A - sigma*B with UMFPACK and runs Lanczos with retry/escalation
logic, this build solves *all* subdomain pencils at once as one batched
dense computation:

    A v = lambda C v,  A SPSD (Neumann), C SPSD (POU-scaled Neumann)

via the inverted-pencil congruence transform

    L = chol(A + eps*I),  S = L^{-1} C L^{-T}  (symmetric PSD),
    eigh(S) -> mu (ascending),  lambda = 1/mu,  v = L^{-T} w.

Largest mu == smallest lambda, so the reference's shift-invert ordering
(spectra.hh:130-138: LargestMagn of the shifted problem == smallest of the
original) is reproduced without any shift, retries, or ncv escalation — the
dense solve returns the full spectrum deterministically, and the adaptive
nev/threshold selection (spectra.hh:157-189) reduces to a masked count.

Common-kernel / padding / Dirichlet modes have mu ~ 0 (lambda -> inf) and
are never selected.  The multi-RHS triangular solves forming L^{-1} are
setup-only.  Every contraction on f32 operands runs at ``HIGHEST``
precision (see solvers/direct.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from functools import lru_cache, partial

from ..solvers.direct import HIGHEST
from .params import EigensolverParams


def cholqr2(W: jnp.ndarray) -> jnp.ndarray:
    """Orthonormalize the columns of a batch of tall blocks (n_sub, p, k) by
    two rounds of column-normalized shifted CholQR.

    Used instead of ``jnp.linalg.qr`` in the refinement loop: CholQR is two
    wide matmuls + a tiny k x k Cholesky.  Column
    normalization first removes the 1e10 eigenvalue-scale spread subspace
    iteration produces (a raw Gram would have cond^2 and break the f64
    factorization); the tiny shift guards exactly-dependent columns; the
    second round restores orthonormality to O(eps).  This is the
    ``WithinBlocks::CholQR2 / ShiftedCholQR3`` scheme of the reference's
    block-Lanczos subsystem (SURVEY.md snapshot caveats;
    dune/ddm/test/test_lanczos_step.cc).
    """
    k = W.shape[-1]
    eye = jnp.eye(k, dtype=W.dtype)
    shift = (1e-14 if W.dtype == jnp.float64 else 1e-6) * k
    for _ in range(2):
        nrm = jnp.sqrt(jnp.sum(W * W, axis=1, keepdims=True))
        W = W / jnp.maximum(nrm, 1e-300 if W.dtype == jnp.float64 else 1e-30)
        G = jnp.einsum("spk,spl->skl", W, W, precision=HIGHEST)
        # shifted CholQR: keeps G PD under exact column dependence
        G = G + shift * eye[None]
        L = jnp.linalg.cholesky(G)
        Linv = jax.lax.linalg.triangular_solve(
            L, jnp.broadcast_to(eye, G.shape), left_side=True, lower=True
        )
        W = jnp.einsum("spk,slk->spl", W, Linv, precision=HIGHEST)  # W L^{-T}
    return W


@partial(jax.jit, static_argnames=("params", "reg", "spd"))
def solve_gevp_dense_jit(A, C, params, reg=1e-12, spd=True):
    """Jit-stable entry point (params is frozen/hashable): reusing this
    across preconditioner builds avoids retracing the full GEVP graph."""
    return solve_gevp_dense(A, C, params, reg=reg, spd=spd)


@partial(jax.jit, static_argnames=("params", "reg", "spd"))
def _gevp_white_jit(A, C, M, Aw, params, reg=1e-12, spd=True):
    return solve_gevp_dense(A, C, params, reg=reg, spd=spd, whiten=(M, Aw))


@partial(jax.jit, static_argnames=("params", "reg", "spd"))
def _gevp_speculative_jit(A, C, params, reg=1e-12, spd=True):
    """ONE program for the common case: pencil prep + stage-0 whitening
    factor + Hutchinson residual probe + the thin-metric GEVP, returning
    the probe residuals alongside the result.  The host checks the
    residuals AFTER the fact and re-runs the escalating path only for
    chunks that failed — the eager staged driver pays 3 jit dispatches
    plus a mid-chunk host sync per chunk."""
    from ..solvers.direct import _whiten_probe

    Areg = _prep_spd_pencil(A, C, params.shift, reg)
    M, resid = _whiten_probe(Areg)
    out = solve_gevp_dense(A, C, params, reg=reg, spd=spd,
                           whiten=(M, None), metric_mat=Areg)
    return out, resid


def _prep_spd_pencil(A, C, shift, reg):
    """The sigma-shifted, diagonally regularized SPD pencil matrix the
    whitener factors (identical to the in-jit prep of solve_gevp_dense)."""
    sigma = float(max(shift, 0.0))
    A = A + sigma * C if sigma > 0.0 else A
    scale = jnp.mean(jnp.abs(jnp.diagonal(A, axis1=1, axis2=2)), axis=1)
    eps = reg * jnp.maximum(scale, 1.0)
    return A + eps[:, None, None] * jnp.eye(A.shape[-1], dtype=A.dtype)[None]


@lru_cache(maxsize=4)
def _prep_jit():
    return jax.jit(_prep_spd_pencil, static_argnames=("shift", "reg"))


def solve_gevp_dense_auto(
    A: jnp.ndarray,
    C: jnp.ndarray,
    params: EigensolverParams,
    reg: float = 1e-12,
    spd: bool = True,
):
    """Dense GEVP with the whitener chosen by ``params.whiten``.

    ``staged`` (the accelerator default via ``auto``) computes the
    congruence factor by host-controlled mixed-precision staged whitening
    (solvers/direct.py:staged_whiten_batched) — f32 Cholesky recurrences +
    f64 square matmuls instead of the f64 Cholesky + triangular inverse —
    and feeds the whitened metric into the generalized Rayleigh-Ritz, so the
    residual whitening error never biases the returned eigenpairs.  The
    host-side residual control cannot run under jit, hence this eager entry;
    ``chol`` / CPU / f64 / non-SPD pencils take the one-jit classic path.
    """
    prec = params.precision
    if prec == "auto":
        # f32 seeds on an accelerator; both routes' GPU times are in PERF.md
        prec = "f64" if jax.default_backend() == "cpu" else "f32"
    downcast = prec == "f32" and A.dtype == jnp.float64
    if params.whiten == "chol" or not (spd and downcast):
        return solve_gevp_dense_jit(A, C, params, reg=reg, spd=spd)
    import os

    from ..solvers.direct import WHITEN_RTOL, staged_whiten_batched

    rtol = float(os.environ.get("DDM_WHITEN_RTOL", WHITEN_RTOL))
    if os.environ.get("DDM_WHITEN_PROBE", "1") != "0":
        # speculative single-program fast path (see _gevp_speculative_jit);
        # the stage-0 probe accepts on the flagship pencils, so wasted
        # speculation is rare
        out, resid = _gevp_speculative_jit(A, C, params, reg=reg, spd=spd)
        import numpy as np

        if (np.asarray(resid) < rtol).all():
            return out
    # escalating path: staged whitening with Aw formed + explicit metric
    Areg = _prep_jit()(A, C, params.shift, reg)
    M, Aw, _ = staged_whiten_batched(Areg, rtol=rtol)
    return _gevp_white_jit(A, C, M, Aw, params, reg=reg, spd=spd)


def solve_gevp_dense(
    A: jnp.ndarray,
    C: jnp.ndarray,
    params: EigensolverParams,
    reg: float = 1e-12,
    spd: bool = True,
    whiten=None,
    metric_mat=None,
):
    """Solve the batched pencil (A, C), keep the smallest-lambda eigenpairs.

    A, C: (n_sub, p, p) symmetric.  Returns (lam (n_sub, m), W (n_sub, m, p)
    eigenvectors as rows, active (n_sub, m) bool) with m = params.max_kept.

    Selection mirrors spectra.hh:157-189: threshold > 0 keeps lambda <
    threshold (at least 1, at most nev_max); threshold <= 0 keeps exactly
    nev.

    spd=False uses an eigendecomposition-based A^{-1/2} instead of Cholesky,
    clipping (spurious) negative A-modes to eps — needed for the *algebraic*
    Neumann matrices of Al Daas et al., which can be slightly indefinite;
    those near-null directions then surface as small lambda, i.e. they join
    the coarse space, which is the desired behavior.

    whiten: optional precomputed congruence pair ``(Linv, Aw)`` with
    ``Aw = Linv Areg Linv^T ~ I`` (from staged_whiten_batched via
    solve_gevp_dense_auto); ``Aw`` enters the generalized Rayleigh-Ritz as
    the metric, making the returned pairs exact Ritz pairs of the true
    pencil even for an inexact whitener.  ``Aw`` may be None with
    ``metric_mat=Areg`` supplied instead (probe-accepted stage-0 whitener):
    the metric is then computed THIN, G = (Linv^T W)^T Areg (Linv^T W) —
    identical math, no (p, p) Aw ever materialized.
    """
    n_sub, p, _ = A.shape
    m = min(params.max_kept, p)

    prec = params.precision
    if prec == "auto":
        prec = "f64" if jax.default_backend() == "cpu" else "f32"
    out_dtype = A.dtype
    downcast = prec == "f32" and A.dtype == jnp.float64

    # NO IDENTITY shift in the mixed-precision path (an earlier 1e-6
    # "shift floor" for f32 stability was measured HARMFUL and removed):
    # ring-pencil eigenvectors have v^T v / v^T C v ~ 1e6 (C lives on a thin
    # pou^2-weighted annulus), so a shift eps*I moves their eigenvalues by
    # eps * v^T v / v^T C v = O(1) — an f64-exact pencil perturbation no
    # refinement can undo.  The C-shift below is different: it is an exact
    # transform of the pencil (same eigenvectors), and it is what makes the
    # f32 eigh seed usable when near-kernel modes coexist with mid-spectrum
    # essentials (ring pencils; scratch/ring_pencil_compare_r3.py).
    # spectral C-shift (params.shift, see eigen/params.py): factor
    # A + sigma*C instead of A — an EXACT pencil transform (identical
    # eigenvectors; mu = 1/(lam + sigma), lam recovered below) that caps the
    # inverted spectrum at 1/sigma so the f32 eigh seed resolves the whole
    # kept block even next to near-kernel modes (mu ~ 1e10).
    sigma = float(max(params.shift, 0.0))
    Aw = None
    if whiten is not None:
        Linv, Aw = whiten
    else:
        A = A + sigma * C if sigma > 0.0 else A
        # regularization scaled by the mean diagonal
        scale = jnp.mean(jnp.abs(jnp.diagonal(A, axis1=1, axis2=2)), axis=1)
        eps = reg * jnp.maximum(scale, 1.0)
        eye = jnp.broadcast_to(jnp.eye(p, dtype=A.dtype), A.shape)
        if spd:
            Areg = A + eps[:, None, None] * jnp.eye(p, dtype=A.dtype)[None]
            from ..solvers.direct import (
                batched_tri_lower_inv,
                use_blocked_tri_inv,
            )

            L = jnp.linalg.cholesky(Areg)
            if (jax.default_backend() == "cpu"
                    or not use_blocked_tri_inv(n_sub)):
                Linv = jax.lax.linalg.triangular_solve(
                    L, eye, left_side=True, lower=True
                )
            else:
                # blocked triangular inversion (solvers/direct.py): the
                # cubic work runs as f64 matmuls; both routes' GPU times
                # are in PERF.md
                Linv = batched_tri_lower_inv(L)
        else:
            d, Q = jnp.linalg.eigh(0.5 * (A + jnp.swapaxes(A, 1, 2)))
            d = jnp.maximum(d, eps[:, None])
            # A^{-1/2} = diag(d^{-1/2}) Q^T  (any square root works for the
            # congruence transform)
            Linv = Q.transpose(0, 2, 1) / jnp.sqrt(d)[:, :, None]
    # with precision f32 the big p x p work — forming S and its
    # eigendecomposition or randomized seed — runs in f32; the Cholesky/Linv
    # stay f64 and the selected subspace is refined back to f64 quality
    # below with cheap nev-wide f64 ops
    import os as _os

    thin_s = (
        downcast
        and whiten is not None
        and metric_mat is not None
        and _os.environ.get("DDM_GEVP_THIN_S", "1") != "0"
    )
    if thin_s:
        # probe-accepted whitener path: S64 is NEVER formed — the f32
        # seed uses an S formed by two f32 matmuls, and every f64
        # refinement application of S runs as a 3-thin-matmul triple
        # Linv (C (Linv^T W)).  At k = m+buf << p the thin triples do less
        # work than the two f64 square matmuls they replace.
        Linv32 = Linv.astype(jnp.float32)
        C32 = C.astype(jnp.float32)
        S = jnp.einsum("spq,sqr->spr", Linv32, C32, precision=HIGHEST)
        S = jnp.einsum("spq,srq->spr", S, Linv32, precision=HIGHEST)
        S = 0.5 * (S + jnp.swapaxes(S, 1, 2))
        S64 = None

        def s64mul(W):
            return jnp.einsum(
                "spq,sqk->spk", Linv,
                jnp.einsum("spq,sqk->spk", C,
                           jnp.einsum("sqp,sqk->spk", Linv, W)))
    elif downcast:
        # form the whitened operator ONCE in f64 (two square matmuls in
        # place of the refinement loop's thin triple products); the f32
        # copy seeds the subspace iteration below.
        S64 = jnp.einsum("spq,sqr->spr", Linv, C)
        S64 = jnp.einsum("spq,srq->spr", S64, Linv)  # Linv C Linv^T
        S64 = 0.5 * (S64 + jnp.swapaxes(S64, 1, 2))
        S = S64.astype(jnp.float32)

        def s64mul(W):
            return jnp.einsum("spq,sqk->spk", S64, W)
    else:
        S = jnp.einsum("spq,sqr,str->spt", Linv, C, Linv)
        S = 0.5 * (S + jnp.swapaxes(S, 1, 2))
    buf = min(params.refine_buf, p - m)
    if downcast and params.seed_mode in ("auto", "subspace"):
        # randomized block subspace iteration replaces the full f32 eigh as
        # the refinement seed (far less work than a full eigh).  The f64
        # refinement below continues the same iteration on the kept block,
        # so seed quality only has to capture the span approximately; the
        # oversampled columns absorb the slow-converging block edge.
        k_seed = min(m + buf + params.seed_oversample, p)
        key = jax.random.PRNGKey(params.seed)
        W32 = jax.random.normal(key, (n_sub, p, k_seed), dtype=jnp.float32)
        for _ in range(params.seed_iters):
            W32 = cholqr2(jnp.einsum("spq,sqk->spk", S, W32,
                                     precision=HIGHEST))
        T = jnp.einsum("spk,spq,sql->skl", W32, S, W32, precision=HIGHEST)
        T = 0.5 * (T + jnp.swapaxes(T, 1, 2))
        mu, Z = jnp.linalg.eigh(T)  # (n_sub, k_seed) ascending, tiny
        Wt = jnp.einsum("spk,skl->spl", W32, Z, precision=HIGHEST)
    else:
        mu, Wt = jnp.linalg.eigh(S)

    # top-m mu == smallest-m lambda; reorder so lambda ascends
    mu_sel = mu[:, -m:][:, ::-1].astype(out_dtype)  # (n_sub, m)
    W_sel = Wt[:, :, -m:][:, :, ::-1].astype(out_dtype)  # (n_sub, p, m)

    if downcast:
        # f64 subspace refinement: block inverse-free subspace iteration on
        # the precomputed f64 S64 + small-block generalized Rayleigh-Ritz.
        # Restores the small-eigenvalue structure f32 eigh
        # loses on high-contrast pencils (without it, GenEO degrades badly
        # at scale: 16 -> >200 iterations on islands 384^2/256 subdomains).
        # The subspace carries `buf` extra seed vectors so the slow-
        # converging block edge lands in the discarded tail rather than in
        # the returned pairs.  The budget comes from params (refine_iters /
        # refine_buf), sized by the offline grid on real bench-scale
        # pencils (scratch/ring_gevp_offline_r3.py): GenEO overlap pencils
        # are accurate at (2, 8) (lam relerr <= 3e-2, and the kept-span
        # metric is degenerate at the cut); thin-support ring pencils need
        # (4, 24) for exact kept spans and their callers override.
        # One thin f64 matmul per iteration (S64 was formed above as a
        # square matmul).  Mid-loop orthonormalization factors are computed in
        # f32: a right-multiplication W @ M preserves span(W) EXACTLY in
        # f64, so only the basis CONDITIONING is f32-approximate — and the
        # final Rayleigh-Ritz below is GENERALIZED (T z = mu G z with
        # G = W^T W), which is f64-exact for any well-conditioned basis,
        # orthonormal or not.
        kw = m + buf

        def ortho_cols_f32(W):
            nrm = jnp.sqrt(jnp.sum(W * W, axis=1, keepdims=True))
            W = W / jnp.maximum(nrm, 1e-300)
            W32 = W.astype(jnp.float32)
            G32 = jnp.einsum("spk,spl->skl", W32, W32, precision=HIGHEST)
            G32 = G32 + (1e-6 * kw) * jnp.eye(kw, dtype=jnp.float32)[None]
            Lg = jnp.linalg.cholesky(G32)
            Li = jax.lax.linalg.triangular_solve(
                Lg,
                jnp.broadcast_to(jnp.eye(kw, dtype=jnp.float32), G32.shape),
                left_side=True, lower=True,
            )
            return jnp.einsum("spk,slk->spl", W, Li.astype(out_dtype))

        W = Wt[:, :, -kw:][:, :, ::-1].astype(out_dtype)
        for _ in range(params.refine_iters):
            W = ortho_cols_f32(s64mul(W))
        # generalized Rayleigh-Ritz on the refined basis, all-f64 small ops
        SW = s64mul(W)
        T = jnp.einsum("spk,spl->skl", W, SW)
        T = 0.5 * (T + jnp.swapaxes(T, 1, 2))
        if Aw is not None:
            # staged whitener: use the actual whitened metric Aw = I + E, so
            # the Ritz pairs are exact for the true pencil regardless of the
            # residual whitening error E (one extra thin f64 matmul)
            AwW = jnp.einsum("spq,sqk->spk", Aw, W)
            G = jnp.einsum("spk,spl->skl", W, AwW)
        elif metric_mat is not None:
            # probe-accepted whitener (Aw never formed): same metric
            # computed thin, G = W^T (Linv Areg Linv^T) W
            #              = (Linv^T W)^T Areg (Linv^T W)
            Y = jnp.einsum("sqp,sqk->spk", Linv, W)
            G = jnp.einsum("spk,spl->skl", Y,
                           jnp.einsum("spq,sqk->spk", metric_mat, Y))
        else:
            # exact f64 whitener: the metric is I up to eps_ds * cond
            G = jnp.einsum("spk,spl->skl", W, W)
        G = 0.5 * (G + jnp.swapaxes(G, 1, 2))
        G = G + (1e-14 * kw) * jnp.eye(kw, dtype=out_dtype)[None]
        Lg = jnp.linalg.cholesky(G)
        eye_k = jnp.broadcast_to(jnp.eye(kw, dtype=out_dtype), G.shape)
        Lgi = jax.lax.linalg.triangular_solve(
            Lg, eye_k, left_side=True, lower=True
        )
        Tw = jnp.einsum("skp,spq,slq->skl", Lgi, T, Lgi)  # Lg^-1 T Lg^-T
        Tw = 0.5 * (Tw + jnp.swapaxes(Tw, 1, 2))
        mu_r, Y = jnp.linalg.eigh(Tw)  # (n_sub, kw) ascending — tiny, f64
        Z = jnp.einsum("sqk,sql->skl", Lgi, Y)  # Lg^-T Y
        mu_sel = mu_r[:, ::-1][:, :m]
        W_sel = jnp.einsum("spk,skl->spl", W, Z[:, :, ::-1][:, :, :m])

    mu_floor = 1e-300 if mu_sel.dtype == jnp.float64 else 1e-30
    lam = 1.0 / jnp.maximum(mu_sel, mu_floor) - sigma
    # v = L^{-T} w, as rows
    V = jnp.einsum("sqp,sqk->skp", Linv, W_sel)  # (n_sub, m, p)
    lam = lam.astype(out_dtype)
    V = V.astype(out_dtype)

    if params.threshold > 0:
        keep = lam < params.threshold
        # at least one vector per subdomain (spectra.hh:162)
        keep = keep.at[:, 0].set(True)
        # monotone prefix (lam ascending => keep is a prefix anyway, but
        # enforce against numerical ties)
        keep = jnp.cumprod(keep.astype(jnp.int32), axis=1).astype(bool)
    else:
        keep = jnp.ones((n_sub, m), bool)
    # degenerate pencils: mu at the floor means lambda -> inf (padding,
    # Dirichlet, or common-kernel modes) — drop them
    keep = keep & (mu_sel > 1e3 * mu_floor)
    keep = keep.at[:, 0].set(keep[:, 0] | (params.threshold <= 0))
    return lam, V, keep
