"""Energy-minimal (discrete-harmonic) extension, batched.

Rebuilds EnergyMinimalExtension (dune/ddm/energy_minimal_extension.hh:36-229):
given Dirichlet data u_b on a constraint set, solve A_ii u_i = -A_ib u_b on
the free set.  The reference extracts an interior submatrix, factors it with
UMFPACK (w/ optional SIMD multi-vector resolves); here the free set is
expressed by a *mask* on the padded dense subdomain batch — rows/cols outside
the free set are replaced by identity — and all right-hand sides (one per
basis vector, over all subdomains) solve in one batched call.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ..solvers.direct import factor_batched


def compact_maps(mask: np.ndarray):
    """Host-side compaction of a per-subdomain dof mask.

    mask (n_sub, n_pad) bool -> (idx, cvalid, pos, r_pad) with
    idx (n_sub, r_pad) int32 listing the masked dofs (0-padded),
    cvalid (n_sub, r_pad) marking real slots, and pos (n_sub, n_pad) the
    inverse map (position in idx, r_pad where unmasked).  This is the batched
    replacement of the reference's ring_to_subdomain index vectors
    (examples/pdelab_helper.hh:281-400): masked regions become their own
    dense padded batch so region eigenproblems run at region size instead
    of masked full size."""
    mask = np.asarray(mask, dtype=bool)
    n_sub, n_pad = mask.shape
    counts = mask.sum(axis=1)
    r_pad = max(int(counts.max()), 1)
    order = np.argsort(~mask, axis=1, kind="stable")
    idx = order[:, :r_pad].astype(np.int32)
    cvalid = np.arange(r_pad)[None, :] < counts[:, None]
    idx = np.where(cvalid, idx, 0).astype(np.int32)
    pos_full = np.empty((n_sub, n_pad), np.int32)
    np.put_along_axis(
        pos_full, order, np.arange(n_pad, dtype=np.int32)[None, :], axis=1
    )
    pos = np.where(mask, pos_full, r_pad).astype(np.int32)
    return idx, cvalid, pos, r_pad


def compact_mat(B: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """(n_sub, p, p) -> (n_sub, r_pad, r_pad) rows/cols at ``idx``.  Both
    gathers move whole rows (contiguous minor dim) with a transpose in
    between instead of gathering columns."""
    B1 = jnp.take_along_axis(B, idx[:, :, None], axis=1)
    B2t = jnp.take_along_axis(B1.transpose(0, 2, 1), idx[:, :, None], axis=1)
    return B2t.transpose(0, 2, 1)


def expand_rows(Vc: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """(n_sub, k, r_pad) compact vectors -> (n_sub, k, n_pad) full-size
    (zeros off the compacted set).  pos from :func:`compact_maps`."""
    Vp = jnp.concatenate(
        [Vc, jnp.zeros(Vc.shape[:2] + (1,), Vc.dtype)], axis=2
    )
    return jnp.take_along_axis(Vp, pos[:, None, :], axis=2)


def masked_operator(A: jnp.ndarray, free_mask: jnp.ndarray) -> jnp.ndarray:
    """A with identity rows/cols outside ``free_mask`` (n_sub, p) — the
    batched equivalent of extracting the A_ii block."""
    f = free_mask.astype(bool)
    keep = f[:, :, None] & f[:, None, :]
    p = A.shape[-1]
    eye = jnp.eye(p, dtype=A.dtype)
    return jnp.where(keep, A, 0.0) + eye[None] * (~f)[:, :, None]


def energy_minimal_extension(
    A: jnp.ndarray,
    free_mask: jnp.ndarray,
    U_bnd: jnp.ndarray,
    solver_type: str = "lu",
) -> jnp.ndarray:
    """Extend boundary data energy-minimally into the free set.

    A: (n_sub, p, p) dense subdomain (Dirichlet) matrices.
    free_mask: (n_sub, p) — dofs solved for ("interior" of the extension).
    U_bnd: (n_sub, nev, p) data vectors; only values OUTSIDE free_mask are
    used as Dirichlet data.
    Returns (n_sub, nev, p): data on the constraint set, extension on the
    free set (zero where the data was zero and the dof is outside both).
    """
    f = free_mask.astype(bool)
    Ub = jnp.where(f[:, None, :], 0.0, U_bnd)
    # rhs_i = -(A u_b)_i on the free set
    R = -jnp.einsum("spq,skq->skp", A, Ub)
    R = jnp.where(f[:, None, :], R, 0.0)
    M = masked_operator(A, f)
    fac = factor_batched(M, solver_type, mode="factors")
    Z = fac.solve(R.transpose(0, 2, 1)).transpose(0, 2, 1)
    Z = jnp.where(f[:, None, :], Z, 0.0)
    return Ub + Z


def energy_minimal_extension_sparse(
    ell,
    topo,
    free_mask: np.ndarray,
    U_bnd: jnp.ndarray,
    local_cols: np.ndarray | None = None,
    solver_type: str = "cholesky",
) -> jnp.ndarray:
    """Energy-minimal extension extracted straight from the global sparse
    operator, at COMPACT free-set size.

    Equivalent to ``energy_minimal_extension(A_dir, free, U_bnd)`` with
    A_dir = the overlapping Dirichlet extraction of ``ell`` (couplings to
    columns outside the subdomain dropped, reference
    examples/pdelab_helper.hh:134-138), but it never materializes the
    (n_sub, p, p) dense batch (~1.5 GB at bench scale) and factors the free
    block at its compacted size f_pad << p — at ring-extension free-set
    sizes the Cholesky costs (f_pad/p)^3 of the full-size one.

    This is the accuracy-correct replacement for the Minv-reuse Schur trick
    (:func:`inverse_harmonic_extension`): that trick's error is
    ~ eps * cond(A)^2 (the M_cc solve amplifies the inverse's own
    eps*cond entry error), which turned O(1) at the flagship's subdomain
    condition ~1e7 on an accelerator whose f64 carried ~48 bits — observed
    as ~12 deg median basis-span error and a 400-iteration GMRES stall at
    384^2/256, while a direct f64 factorization of A_ff (error eps*cond)
    stays exact.

    ell: SparseELL (global, Dirichlet-eliminated, optionally equilibrated);
    topo: DDMTopology; free_mask: host bool (n_sub, n_pad); U_bnd
    (n_sub, nev, n_pad) with data read outside free_mask; ``local_cols`` the
    precomputed extraction map (computed here when absent).  Same return
    contract as :func:`energy_minimal_extension`.
    """
    import jax.numpy as jnp

    from ..core.indexmaps import extraction_map

    f_np = np.asarray(free_mask, bool) & topo.valid
    n_sub, n_pad = f_np.shape
    idx, fval, pos, f_pad = compact_maps(f_np)
    if local_cols is None:
        local_cols = extraction_map(topo, np.asarray(ell.colsT).T)
    lc_f = np.take_along_axis(local_cols, idx[:, :, None], axis=1)
    rows_g = np.take_along_axis(topo.sub2glob, idx, axis=1)
    rows_g = np.minimum(rows_g, ell.n - 1)

    vals, _ = ell.rows_dense_gather(jnp.asarray(rows_g))  # (n_sub, f_pad, m)
    fval_j = jnp.asarray(fval)
    vals = vals * fval_j[:, :, None]
    # rectangular free-row block (n_sub, f_pad, n_pad): rows = free dofs,
    # cols = all subdomain-local dofs (dropped couplings land in slot n_pad)
    k_idx = jnp.arange(n_sub)[:, None, None]
    r_idx = jnp.arange(f_pad)[None, :, None]
    rect = jnp.zeros((n_sub, f_pad, n_pad + 1), vals.dtype)
    rect = rect.at[k_idx, r_idx, jnp.asarray(lc_f)].add(vals)[:, :, :n_pad]

    f_j = jnp.asarray(f_np)
    Ub = jnp.where(f_j[:, None, :], 0.0, U_bnd)
    R = -jnp.einsum("sfp,skp->skf", rect, Ub)  # (n_sub, nev, f_pad)

    idx_j = jnp.asarray(idx)
    Aff = jnp.take_along_axis(
        rect.transpose(0, 2, 1), idx_j[:, :, None], axis=1
    ).transpose(0, 2, 1)
    Aff = jnp.where(fval_j[:, :, None] & fval_j[:, None, :], Aff, 0.0)
    Aff = Aff + jnp.eye(f_pad, dtype=Aff.dtype)[None] * (~fval_j)[:, :, None]

    fac = factor_batched(Aff, solver_type, mode="factors")
    Z = fac.solve(R.transpose(0, 2, 1)).transpose(0, 2, 1)
    Z = Z * fval_j[:, None, :]
    return Ub + expand_rows(Z, jnp.asarray(pos))


def _pcg_blocks(A, M, B, maxit: int, X0=None):
    """Batched preconditioned CG: solve A X = B for every (subdomain, rhs)
    pair at once.  A, M: (s, f, f) SPD (M = preconditioner, applied
    explicitly); B: (s, f, k).  Returns (X, rel) with rel (s, k) the final
    true-residual norms relative to ||B|| columns (0 where B = 0).

    The products are per-RHS multiply+reduce passes (no dot_general).
    Fixed ``maxit`` keeps the loop compile-friendly;
    converged columns freeze via a mask instead of exiting early.
    """
    from jax import lax

    k_rhs = B.shape[-1]

    def mv(K, V):
        # per-RHS multiply+reduce: one fused bandwidth-bound pass per
        # column instead of a narrow dot_general (not yet timed against
        # einsum on the GPU, ROADMAP A7)
        cols = [
            jnp.sum(K * V[:, None, :, j], axis=2) for j in range(k_rhs)
        ]
        return jnp.stack(cols, axis=2)

    b2 = jnp.sum(B * B, axis=1)  # (s, k)
    if X0 is None:
        X0 = jnp.zeros_like(B)
        R0 = B
    else:
        R0 = B - mv(A, X0)
    Z0 = mv(M, R0)
    rz0 = jnp.sum(R0 * Z0, axis=1)

    def body(_, carry):
        X, R, Z, P, rz = carry
        Q = mv(A, P)
        pq = jnp.sum(P * Q, axis=1)
        live = (rz > 0.0) & (pq > 0.0)
        alpha = jnp.where(live, rz / jnp.where(pq > 0.0, pq, 1.0), 0.0)
        X = X + alpha[:, None, :] * P
        R = R - alpha[:, None, :] * Q
        Z = mv(M, R)
        rz_new = jnp.sum(R * Z, axis=1)
        beta = jnp.where(live, rz_new / jnp.where(rz > 0.0, rz, 1.0), 0.0)
        P = Z + beta[:, None, :] * P
        return X, R, Z, P, rz_new

    X, R, _, _, _ = lax.fori_loop(
        0, maxit, body, (X0, R0, Z0, Z0, rz0)
    )
    # true residual (the recurrence R drifts once columns converge)
    Rt = B - mv(A, X)
    rel = jnp.sqrt(jnp.sum(Rt * Rt, axis=1) / jnp.where(b2 > 0.0, b2, 1.0))
    rel = jnp.where(b2 > 0.0, rel, 0.0)
    return X, rel


@functools.lru_cache(maxsize=None)
def _pcg_blocks_jit(maxit: int):
    import jax

    return jax.jit(lambda A, M, B: _pcg_blocks(A, M, B, maxit))


@functools.lru_cache(maxsize=None)
def _pcg_blocks_mixed_jit(maxit32: int, maxit64: int):
    """Two-stage PCG: f32 stage (multiply+reduce products, no contraction
    whose precision could drop to TF32) down to its ~eps32·cond
    true-residual floor, then a warm-started f64 polish.  The polish recomputes R = B - A X0 in f64, so the f32
    stage can only shorten the f64 work, never bias the answer — callers
    verify the final residual and fall back regardless."""
    import jax

    def run(A, M, B):
        f32 = jnp.float32
        X32, _ = _pcg_blocks(
            A.astype(f32), M.astype(f32), B.astype(f32), maxit32
        )
        return _pcg_blocks(A, M, B, maxit64, X0=X32.astype(B.dtype))

    return jax.jit(run)


def energy_minimal_extension_pcg(
    ell,
    topo,
    free_mask: np.ndarray,
    U_bnd: jnp.ndarray,
    Minv: jnp.ndarray,
    local_cols: np.ndarray | None = None,
    maxit: int = 60,
    maxit32: int = 0,
):
    """Energy-minimal extension by preconditioned CG, reusing the fine
    Schwarz level's explicit subdomain inverse as the preconditioner —
    no second f64 factorization.

    The direct route (:func:`energy_minimal_extension_sparse`) pays a
    batched f64 Cholesky of the compacted free block, which can erase most
    of the ring's smaller-GEVP win.
    Here instead: CG on A_ff with P = (A^{-1})_ff (the free-free block of
    the inverse the Schwarz level already holds).  For SPD A,
    (A^{-1})_ff = (A_ff - A_fc A_cc^{-1} A_cf)^{-1}, so P A_ff = I - (small
    boundary-strip correction) and CG contracts fast.  Unlike the reverted
    Minv Schur identity (eps*cond^2 accuracy failure, see
    :func:`energy_minimal_extension_sparse`), PCG is residual-controlled:
    inverse entry noise only slows the rate, never floors the answer.

    Returns (U, rel): same contract as the sparse variant, plus the final
    per-(subdomain, vector) relative residuals so callers can verify and
    fall back to the direct factorization if contraction was poor.

    ``maxit32 > 0`` prepends an f32 PCG stage of that many iterations and
    warm-starts ``maxit`` f64 iterations from its result (see
    :func:`_pcg_blocks_mixed_jit`); 0 runs pure f64.
    """
    from ..core.indexmaps import extraction_map

    f_np = np.asarray(free_mask, bool) & topo.valid
    n_sub, n_pad = f_np.shape
    idx, fval, pos, f_pad = compact_maps(f_np)
    fval_j = jnp.asarray(fval)
    idx_j = jnp.asarray(idx)
    rmeta = getattr(topo, "rect", None)
    from ..core.mesh import batched
    from ..precond.extract import extract_subdomain_dense, rect_extract_ok

    if rect_extract_ok(ell, rmeta, n_pad):
        # scatter-free: dense canvas extraction + row compaction by
        # take_along_axis (row gathers from a 3-D operand) — replaces the
        # (n_sub, f_pad, m) at[].add below
        A_dir = extract_subdomain_dense(
            ell, batched(topo.sub2glob), batched(jnp.asarray(topo.valid)),
            None, unit_padding_diag=False, rect=rmeta,
        )
        rect = jnp.take_along_axis(A_dir, idx_j[:, :, None], axis=1)
        del A_dir
        rect = rect * fval_j[:, :, None]
    else:
        if local_cols is None:
            local_cols = extraction_map(topo, np.asarray(ell.colsT).T)
        lc_f = np.take_along_axis(local_cols, idx[:, :, None], axis=1)
        rows_g = np.take_along_axis(topo.sub2glob, idx, axis=1)
        rows_g = np.minimum(rows_g, ell.n - 1)

        vals, _ = ell.rows_dense_gather(jnp.asarray(rows_g))
        vals = vals * fval_j[:, :, None]
        k_idx = jnp.arange(n_sub)[:, None, None]
        r_idx = jnp.arange(f_pad)[None, :, None]
        rect = jnp.zeros((n_sub, f_pad, n_pad + 1), vals.dtype)
        rect = rect.at[k_idx, r_idx, jnp.asarray(lc_f)].add(vals)[:, :, :n_pad]

    f_j = jnp.asarray(f_np)
    Ub = jnp.where(f_j[:, None, :], 0.0, U_bnd)
    R = -jnp.einsum("sfp,skp->sfk", rect, Ub)  # (n_sub, f_pad, nev)
    R = R * fval_j[:, :, None]

    Aff = jnp.take_along_axis(
        rect.transpose(0, 2, 1), idx_j[:, :, None], axis=1
    ).transpose(0, 2, 1)
    keep = fval_j[:, :, None] & fval_j[:, None, :]
    Aff = jnp.where(keep, Aff, 0.0)
    Aff = Aff + jnp.eye(f_pad, dtype=Aff.dtype)[None] * (~fval_j)[:, :, None]
    del rect

    Mff = compact_mat(Minv, idx_j)
    Mff = jnp.where(keep, Mff, 0.0)
    Mff = Mff + jnp.eye(f_pad, dtype=Mff.dtype)[None] * (~fval_j)[:, :, None]

    if maxit32 > 0:
        Z, rel = _pcg_blocks_mixed_jit(int(maxit32), int(maxit))(Aff, Mff, R)
    else:
        Z, rel = _pcg_blocks_jit(int(maxit))(Aff, Mff, R)
    Z = Z.transpose(0, 2, 1) * fval_j[:, None, :]
    return Ub + expand_rows(Z, jnp.asarray(pos)), rel


def extension_inverse_of(fine, p, ptree) -> jnp.ndarray | None:
    """The fine Schwarz level's explicit subdomain inverse, when it is an
    exact f64 inverse of the same overlapping Dirichlet matrix the extension
    would factor — i.e. when :func:`inverse_harmonic_extension` may replace
    the extension's own factorization.  None otherwise (dd/f32 apply modes,
    non-inverse factor modes, modified subdomain matrices, indefinite
    problems)."""
    from ..solvers.direct import BatchedInverse

    if fine is None:
        return None
    if ptree.get("modify_subdomain_matrix", False):
        return None
    if not getattr(p.disc, "definite", True):
        return None
    if ptree.sub("schwarz").sub("subdomain_solver").get("type", "") not in (
        "cholesky", "cholmod",
    ):
        return None
    factors = getattr(fine, "factors", None)
    if not isinstance(factors, BatchedInverse):
        return None
    if factors.inv.dtype != jnp.float64:
        return None
    return factors.inv


def inverse_harmonic_extension(
    Minv: jnp.ndarray,
    free_mask: jnp.ndarray,
    U_bnd: jnp.ndarray,
    c_mask: np.ndarray,
) -> jnp.ndarray:
    """Energy-minimal extension through the subdomain *inverse* (Schur
    identity) — no second factorization.

    For SPD A with M = A^{-1} and dof partition {f (free), c (complement)}:
    -A_ff^{-1} A_fc = M_fc M_cc^{-1}, so the masked extension solve
    A_ff u_f = -A_fc u_c evaluates as u = M z with M_cc z_c = u_c, z zero
    off c.  The Schwarz level already holds M explicitly (BatchedInverse);
    M_cc is the (much smaller) complement block, factored batched.  The
    reference instead pays a dedicated UMFPACK factorization of A_ii per
    rank (energy_minimal_extension.hh:78-88).

    Minv: (n_sub, p, p) the f64 explicit inverse; free_mask (n_sub, p);
    U_bnd (n_sub, nev, p) with data read outside free_mask; c_mask: host
    bool (n_sub, p), the complement set (valid & ~free).  Same return
    contract as :func:`energy_minimal_extension`.
    """
    f = free_mask.astype(bool)
    Ub = jnp.where(f[:, None, :], 0.0, U_bnd)
    c_idx, cval, _pos, _c_pad = compact_maps(c_mask)
    c_idx = jnp.asarray(c_idx)
    cval = jnp.asarray(cval)
    Mcc = compact_mat(Minv, c_idx)
    keep = cval[:, :, None] & cval[:, None, :]
    Mcc = jnp.where(keep, Mcc, 0.0) + jnp.eye(Mcc.shape[-1])[None] * (
        ~cval
    )[:, :, None]
    Uc = jnp.take_along_axis(Ub, c_idx[:, None, :], axis=2)
    Uc = jnp.where(cval[:, None, :], Uc, 0.0)
    fac = factor_batched(Mcc, "cholesky", mode="factors")
    Zc = fac.solve(Uc.transpose(0, 2, 1))  # (n_sub, c_pad, nev)
    # scatter back into full-size z (zero off c), then one wide matmul
    n_sub, p, _ = Minv.shape
    s_idx = jnp.arange(n_sub)[:, None, None]
    z = jnp.zeros((n_sub, p + 1, Zc.shape[-1]), Zc.dtype)
    z = z.at[s_idx, jnp.where(cval, c_idx, p)[:, :, None],
             jnp.arange(Zc.shape[-1])[None, None, :]].add(Zc)[:, :p]
    U = jnp.einsum("spq,sqk->spk", Minv, z).transpose(0, 2, 1)
    return Ub + jnp.where(f[:, None, :], U, 0.0)


def compact_cols(B: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """(n_sub, p, q) -> (n_sub, p, b_pad): columns at ``idx`` (n_sub, b_pad),
    moved through a transpose so the gather is a row gather."""
    Bt = jnp.take_along_axis(B.transpose(0, 2, 1), idx[:, :, None], axis=1)
    return Bt.transpose(0, 2, 1)


def harmonic_parameter_basis_compact(
    A_con: jnp.ndarray,
    int_mask: jnp.ndarray,
    par_idx: jnp.ndarray,
    par_valid: jnp.ndarray,
    solver_type: str = "lu",
) -> jnp.ndarray:
    """Column-compacted :func:`harmonic_parameter_basis`: returns
    Hc (n_sub, p, b_pad) with u = Hc @ w for parameter data w at the dofs
    listed in ``par_idx`` (n_sub, b_pad; ``par_valid`` marks real slots).
    Identical math, but the solve carries b_pad right-hand sides instead of
    p mostly-zero ones — the compaction that makes the ring-MsGFEM pencil
    b_pad-sized (reference: the ring_dofs/reordering vectors of
    MsGFEMRingCoarseSpace, coarse_spaces.hh:966-1096)."""
    i = int_mask.astype(bool)
    Aip = compact_cols(jnp.where(i[:, :, None], A_con, 0.0), par_idx)
    Aip = jnp.where(par_valid[:, None, :], Aip, 0.0)
    M = masked_operator(A_con, i)
    fac = factor_batched(M, solver_type, mode="factors")
    X = -fac.solve(Aip)
    X = jnp.where(i[:, :, None] & par_valid[:, None, :], X, 0.0)
    p = A_con.shape[-1]
    E = (jnp.arange(p)[None, :, None] == par_idx[:, None, :]) & par_valid[
        :, None, :
    ]
    return X + E.astype(A_con.dtype)


def harmonic_parameter_basis(
    A_con: jnp.ndarray,
    int_mask: jnp.ndarray,
    par_mask: jnp.ndarray,
    solver_type: str = "lu",
) -> jnp.ndarray:
    """Implicit basis of the A-harmonic space: returns Hfull (n_sub, p, p)
    with u = Hfull @ w for parameter data w supported on ``par_mask``;
    columns outside par_mask are zero.

    Hfull = [X; I] with X = -A_ii^{-1} A_i,par (the constraint
    (A_con u)_i = 0 for i in int_mask solved for all unit parameter data at
    once — the batched replacement of the reference's saddle-point Lagrange
    blocks, coarse_spaces.hh:763-778).
    """
    i = int_mask.astype(bool)
    b = par_mask.astype(bool)
    Aip = jnp.where(i[:, :, None] & b[:, None, :], A_con, 0.0)
    M = masked_operator(A_con, i)
    fac = factor_batched(M, solver_type, mode="factors")
    X = -fac.solve(Aip)
    X = jnp.where(i[:, :, None] & b[:, None, :], X, 0.0)
    p = A_con.shape[-1]
    eye = jnp.eye(p, dtype=A_con.dtype)
    return X + eye[None] * b[:, None, :].astype(A_con.dtype)
