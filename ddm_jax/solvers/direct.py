"""Batched dense direct solvers for subdomain problems.

This is the batched replacement (SURVEY.md §7.1 decision 4) of the
reference's sparse direct stack:

* UMFPACK / CHOLMOD / STRUMPACK subdomain factorizations
  (dune/ddm/schwarz.hh:85-92 via the ISTL solver factory)
* the SIMD multi-RHS triangular resolve ``UMFPackMultivecSolver``
  (dune/ddm/eigensolvers/umfpack.hh:132-251) — here a batched triangular
  solve over trailing RHS dims is simply ``solve`` with a matrix RHS.

Subdomain matrices arrive as a padded dense batch (n_sub, p, p); padding
diagonal slots must already be 1 (see precond/extract.py) so factorizations
are well-defined.  Factor once at setup, apply per Krylov iteration — exactly
the factorise/resolve split of the reference.

Solver names accepted by :func:`factor_batched` keep the reference's config
strings working: ``umfpack`` (LU), ``cholmod`` (Cholesky), plus the native
names ``lu`` and ``cholesky``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

# Every contraction on f32 operands names this precision: a GPU may otherwise
# compute an f32 product in TF32 (~10 mantissa bits), which breaks the
# double-single contract below and shifts the f32-seeded accept tests.
HIGHEST = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclass
class BatchedLU:
    lu: jnp.ndarray  # (n_sub, p, p)
    piv: jnp.ndarray  # (n_sub, p)

    def solve(self, b: jnp.ndarray) -> jnp.ndarray:
        """b: (n_sub, p) or (n_sub, p, k)."""
        squeeze = b.ndim == 2
        if squeeze:
            b = b[..., None]
        x = jax.vmap(lambda lu, piv, bb: jax.scipy.linalg.lu_solve((lu, piv), bb))(
            self.lu, self.piv, b
        )
        return x[..., 0] if squeeze else x


@jax.tree_util.register_dataclass
@dataclass
class BatchedCholesky:
    chol: jnp.ndarray  # (n_sub, p, p) lower factors

    def solve(self, b: jnp.ndarray) -> jnp.ndarray:
        squeeze = b.ndim == 2
        if squeeze:
            b = b[..., None]
        y = jax.lax.linalg.triangular_solve(
            self.chol, b, left_side=True, lower=True, transpose_a=False
        )
        x = jax.lax.linalg.triangular_solve(
            self.chol, y, left_side=True, lower=True, transpose_a=True
        )
        return x[..., 0] if squeeze else x


@jax.tree_util.register_dataclass
@dataclass
class BatchedQR:
    """Householder QR factors (``subdomain_solver.type = qr``): an
    unpivoted nonsymmetric factorization with the same O(p^3) setup /
    O(p^2) apply complexity as LU."""

    q: jnp.ndarray  # (n_sub, p, p)
    r: jnp.ndarray  # (n_sub, p, p)

    def solve(self, b: jnp.ndarray) -> jnp.ndarray:
        squeeze = b.ndim == 2
        if squeeze:
            b = b[..., None]
        y = jnp.einsum("spq,spk->sqk", self.q, b)  # Q^T b
        x = jax.lax.linalg.triangular_solve(
            self.r, y, left_side=True, lower=False, transpose_a=False
        )
        return x[..., 0] if squeeze else x


def bmv(M: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Batched matvec (..., p, q) @ (..., q) -> (..., p) as an elementwise
    multiply + reduction instead of dot_general.

    Used for every single-RHS matvec on the apply path; multi-RHS (wide)
    products stay dot_general.  The formulation was chosen on the first
    accelerator this code ran on and is not yet timed against ``einsum`` on
    the GPU (ROADMAP A7).  Summation order differs from dot_general by
    reduction tiling only — same f64 arithmetic."""
    return (M * x[..., None, :]).sum(axis=-1)


@jax.tree_util.register_dataclass
@dataclass
class BatchedInverse:
    """Explicit subdomain inverses: apply = one batched matvec pass.

    Single-RHS triangular substitution is sequential (p steps), while
    applying a precomputed inverse is one bandwidth-bound pass over
    (n_sub, p, p).  The inverse is formed once at setup from the triangular
    factors (multi-RHS solve against I); for Cholesky it is built as
    L^{-T} L^{-1} so the preconditioner stays exactly symmetric for CG.
    Single-RHS applies use :func:`bmv`, multi-RHS applies stay matmuls.

    Accuracy note: applying an explicit inverse carries a cond(A)*eps error
    per apply — harmless for a *preconditioner* (it only nudges iteration
    counts; the Krylov solver controls the true residual).
    """

    inv: jnp.ndarray  # (n_sub, p, p); may be stored in f32 (see store_dtype)

    def solve(self, b: jnp.ndarray) -> jnp.ndarray:
        bc = b.astype(self.inv.dtype)
        if b.ndim == 2:
            out = bmv(self.inv, bc)
        else:
            out = jnp.einsum("spq,sqk->spk", self.inv, bc,
                             precision=HIGHEST)
        return out.astype(b.dtype)


def dd_split(a: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Split f64 into a double-single (hi, lo) f32 pair: hi + lo == a to
    ~2^-48 relative — an (effectively) exact representation, unlike a plain
    f32 cast (whose eps32·cond representation error is what made the f32
    fine-level apply stall; see CLAUDE.md failed experiments)."""
    hi = a.astype(jnp.float32)
    lo = (a - hi.astype(jnp.float64)).astype(jnp.float32)
    return hi, lo


def dd_matmul(Ah, Al, Bh, Bl, eq: str = "spq,sqr->spr") -> jnp.ndarray:
    """(Ah+Al) @ (Bh+Bl) via three f32 matmuls, combined in f64.

    The O(eps32^2) Al@Bl term is dropped (below the f32-accumulation noise).
    The products run at ``HIGHEST`` precision: true f32 accumulation is part
    of the double-single contract."""
    t0 = jnp.einsum(eq, Ah, Bh, precision=HIGHEST)
    t1 = (jnp.einsum(eq, Al, Bh, precision=HIGHEST)
          + jnp.einsum(eq, Ah, Bl, precision=HIGHEST))
    return t0.astype(jnp.float64) + t1.astype(jnp.float64)


def dd_matvec(hi: jnp.ndarray, lo: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """y = (hi+lo) @ d via three f32 matvecs, combined in f64.

    d: (n_sub, p) or (n_sub, p, k) f64.  Per-apply arithmetic noise is the
    f32 accumulation (~1e-6 relative, incoherent between applies); the
    operator itself is represented to ~2^-48.  The products run at
    ``HIGHEST`` precision — a TF32 product would raise the noise to ~1e-3."""
    dh = d.astype(jnp.float32)
    dl = (d - dh.astype(jnp.float64)).astype(jnp.float32)
    if d.ndim == 2:
        eq = "spq,sq->sp"
    else:
        eq = "spq,sqk->spk"
    y0 = jnp.einsum(eq, hi, dh, precision=HIGHEST)
    y1 = (jnp.einsum(eq, lo, dh, precision=HIGHEST)
          + jnp.einsum(eq, hi, dl, precision=HIGHEST))
    return y0.astype(jnp.float64) + y1.astype(jnp.float64)


@jax.tree_util.register_dataclass
@dataclass
class BatchedInverseDD:
    """Explicit subdomain inverses in double-single storage: f64-grade
    operator representation, f32 arithmetic (see :func:`dd_matvec`).

    Optional exact sparse-f64 defect correction (``sub_vals/sub_cols`` as in
    :class:`SparseRefinedInverse`) squashes the residual f32 accumulation
    noise coherently; ``steps=0`` disables it."""

    inv_hi: jnp.ndarray  # (n_sub, p, p) float32
    inv_lo: jnp.ndarray  # (n_sub, p, p) float32
    sub_vals: jnp.ndarray | None = None  # (n_sub, p, m) f64 sparse rows
    sub_cols: jnp.ndarray | None = None  # (n_sub, p, m) int32, dummy == p
    steps: int = field(default=0, metadata=dict(static=True))

    def _amul(self, x: jnp.ndarray) -> jnp.ndarray:
        """Exact f64 A_sub @ x via the sparse rows; x: (n_sub, p[, k])."""
        vec = x.ndim == 2
        if vec:
            x = x[:, :, None]
        n_sub, p, k = x.shape
        pad = jnp.concatenate([x, jnp.zeros((n_sub, 1, k), x.dtype)], axis=1)
        xs = jnp.take_along_axis(
            pad, self.sub_cols.reshape(n_sub, -1, 1), axis=1
        ).reshape(*self.sub_cols.shape, k)
        y = (self.sub_vals[..., None] * xs).sum(axis=2)
        return y[:, :, 0] if vec else y

    def solve(self, b: jnp.ndarray) -> jnp.ndarray:
        x = dd_matvec(self.inv_hi, self.inv_lo, b)
        for _ in range(self.steps):
            r = b - self._amul(x)
            x = x + dd_matvec(self.inv_hi, self.inv_lo, r)
        return x


@jax.tree_util.register_dataclass
@dataclass
class SparseRefinedInverse:
    """f32 explicit inverse + f64 iterative refinement with *sparse*
    subdomain residuals.

    The fast path stores the subdomain inverse in f32 (half the memory
    traffic of f64), which alone is a poor preconditioner when cond(A_sub)
    approaches 1/eps_f32 (high-contrast subdomains).  Each apply therefore runs `steps` rounds of defect
    correction

        x <- x + X32 (b - A_sub x)

    where A_sub x is computed EXACTLY in f64 from the subdomain's sparse
    rows (vals/cols gathered once from the global ELL matrix at setup —
    O(nnz) instead of O(p^2)).  This is the batched form of the
    reference's blockwise backward-error iterative refinement
    (dune/ddm/eigensolvers/umfpack.hh:42-129).
    """

    inv32: jnp.ndarray  # (n_sub, p, p) float32
    sub_vals: jnp.ndarray  # (n_sub, p, m) float64 — A_dir rows, sparse
    sub_cols: jnp.ndarray  # (n_sub, p, m) int32 local cols, dummy == p
    steps: int = field(default=2, metadata=dict(static=True))

    def _amul(self, x: jnp.ndarray) -> jnp.ndarray:
        """Exact f64 A_sub @ x via the sparse rows; x: (n_sub, p)."""
        n_sub, p = x.shape
        pad = jnp.concatenate([x, jnp.zeros((n_sub, 1), x.dtype)], axis=1)
        xs = jnp.take_along_axis(
            pad, self.sub_cols.reshape(n_sub, -1), axis=1
        ).reshape(self.sub_cols.shape)
        return (self.sub_vals * xs).sum(axis=2)

    def _fast(self, b: jnp.ndarray) -> jnp.ndarray:
        return jnp.einsum(
            "spq,sq->sp", self.inv32, b.astype(jnp.float32),
            precision=HIGHEST,
        ).astype(b.dtype)

    def solve(self, b: jnp.ndarray) -> jnp.ndarray:
        squeeze = b.ndim == 3
        if squeeze:  # multi-RHS: refine each column
            return jnp.stack(
                [self.solve(b[..., k]) for k in range(b.shape[-1])], axis=-1
            )
        x = self._fast(b)
        for _ in range(self.steps):
            r = b - self._amul(x)
            x = x + self._fast(r)
        return x


def batch_chunk_size(p: int, dtype_bytes: int = 8, live_buffers: int = 20,
                     budget_bytes: int | None = None) -> int:
    """How many (p, p) subdomain blocks fit comfortably through a dense
    factorization pipeline at once.  The setup ops (extract -> cholesky ->
    triangular inverse -> Newton refine, or the GEVP transform + eigh) hold
    O(live_buffers) batch-sized temporaries; chunking the subdomain batch
    bounds peak device memory while keeping each chunk large enough to fill
    the device.  Override with env DDM_BATCH_CHUNK.

    The 6 GB default budget was sized for a 16 GB device and is not yet
    measured on an 80 GB card (ROADMAP B7)."""
    import os

    env = os.environ.get("DDM_BATCH_CHUNK")
    if env:
        return max(1, int(env))
    if budget_bytes is None:
        budget_bytes = 6 << 30
    per = p * p * dtype_bytes * live_buffers
    return max(1, budget_bytes // max(per, 1))


from functools import lru_cache


@lru_cache(maxsize=64)
def factor_batched_jit(solver_type: str, mode: str = "auto",
                       refine_steps: int | None = None, store_dtype=None):
    """Cached jitted factorization entry: stable function identity across
    preconditioner builds (a fresh jax.jit(lambda ...) per build retraces
    the whole factorization graph every time)."""
    return jax.jit(
        lambda A: factor_batched(A, solver_type, mode=mode,
                                 refine_steps=refine_steps,
                                 store_dtype=store_dtype)
    )


def chunked_batch(fn, *arrays, chunk: int | None = None):
    """Apply a batched op over subdomain chunks, concatenating results.

    All ``arrays`` are split along axis 0.  fn should be jitted by the
    caller; identical chunk shapes reuse one compilation (remainders compile
    a second shape).

    Under an active setup_sharding context (core/mesh.py) the chunk budget is
    per-DEVICE — each device only materialises its 1/n_dev slice of a chunk —
    so the effective chunk scales by the mesh size, and each chunk slice is
    re-committed to the subdomain sharding so XLA keeps partitioning the
    batched op."""
    from ..core.mesh import active_setup

    A = arrays[0]
    n = A.shape[0]
    ctx = active_setup()
    n_dev = ctx[0].shape[ctx[1]] if ctx is not None else 1
    if chunk is None:
        chunk = batch_chunk_size(A.shape[-1], A.dtype.itemsize) * n_dev
    if ctx is not None:
        # keep every chunk evenly sharded over the mesh axis
        chunk = max(n_dev, chunk - chunk % n_dev)
    if chunk >= n:
        return fn(*arrays)
    outs = []
    fill = None  # in-place accumulation (see below), engaged after slab 0
    i = 0
    while i < n:
        j = min(i + chunk, n)
        piece = tuple(a[i:j] for a in arrays)
        if ctx is not None and (j - i) % n_dev == 0:
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as P

            mesh, axis, _ = ctx
            sh = NamedSharding(mesh, P(axis))
            piece = tuple(jax.device_put(x, sh) for x in piece)
        out = fn(*piece)
        if i == 0 and ctx is None:
            # When every output leaf is batch-leading, fill a preallocated
            # batch via DONATED dynamic_update_slice instead of
            # list+concatenate: the concat holds every slab plus the result
            # (2x the batch) and async dispatch keeps several slabs'
            # temporaries live at once — that ran out of memory on a 16 GB
            # device at the 3-D bench (512 x 1000 x 1000 f64 = 4.1 GB per
            # batch).  Waiting on each slab retires its temporaries before
            # the next is enqueued.  Sharded setups keep the concat path (chunks are
            # committed per-device; donation would fight the re-commit).
            leaves = jax.tree_util.tree_leaves(out)
            if all(
                hasattr(x, "shape") and x.ndim >= 1 and x.shape[0] == j - i
                for x in leaves
            ):
                fill = jax.tree_util.tree_map(
                    lambda x: jnp.zeros((n,) + x.shape[1:], x.dtype), out
                )
        if fill is not None:
            fill = jax.tree_util.tree_map(
                lambda acc, x: _dus0_jit()(acc, x, i), fill, out
            )
            jax.block_until_ready(fill)
        else:
            outs.append(out)
        i += chunk
    if fill is not None:
        return fill
    return jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=0), *outs
    )


@lru_cache(maxsize=1)
def _dus0_jit():
    return jax.jit(
        lambda out, slab, i: jax.lax.dynamic_update_slice_in_dim(
            out, slab, i, axis=0
        ),
        donate_argnums=0,
    )


_LU_NAMES = {"lu", "umfpack", "superlu", "strumpack"}
_CHOL_NAMES = {"cholesky", "cholmod"}
_QR_NAMES = {"qr"}


def resolve_solver_type(solver_type: str) -> str:
    """Map reference solver names to the factorization actually used."""
    st = solver_type.lower()
    if st in _CHOL_NAMES:
        return "cholesky"
    if st in _QR_NAMES:
        return "qr"
    if st in _LU_NAMES:
        return "lu"
    raise ValueError(f"Unknown subdomain solver type '{solver_type}'")


def batched_cholesky_blocked(A: jnp.ndarray, nb: int = 128) -> jnp.ndarray:
    """Batched Cholesky with the cubic work as f64 square matmuls.

    The standard left-looking block algorithm: all O(p^3) work runs as
    nb x nb matmuls, leaving only B diagonal-block factorizations and
    B(B-1)/2 small triangular solves to XLA's recurrences.

    A: (n_sub, p, p) SPD.  Returns lower L with L L^T = A (padding blocks
    handled; exact same math as lax.linalg.cholesky up to roundoff).
    """
    n_sub, p, _ = A.shape
    B = -(-p // nb)
    P = B * nb
    if P != p:
        Ap = jnp.zeros((n_sub, P, P), A.dtype)
        Ap = Ap.at[:, :p, :p].set(A)
        Ap = Ap.at[:, jnp.arange(p, P), jnp.arange(p, P)].set(1.0)
        A = Ap
    blk = A.reshape(n_sub, B, nb, B, nb).transpose(0, 1, 3, 2, 4)
    L = [[None] * B for _ in range(B)]
    for k in range(B):
        S = blk[:, k, k]
        if k:
            S = S - sum(
                jnp.einsum("spq,srq->spr", L[k][j], L[k][j])
                for j in range(k)
            )
        Lkk = jnp.linalg.cholesky(S)
        L[k][k] = Lkk
        if k + 1 < B:
            # panel: L[i][k] = S_i L_kk^{-T}  via small triangular solves
            Si = blk[:, k + 1:, k]  # (n_sub, B-k-1, nb, nb)
            if k:
                Si = Si - jnp.stack(
                    [
                        sum(
                            jnp.einsum("spq,srq->spr", L[i][j], L[k][j])
                            for j in range(k)
                        )
                        for i in range(k + 1, B)
                    ],
                    axis=1,
                )
            Lkk_b = jnp.broadcast_to(
                Lkk[:, None], (n_sub, B - k - 1, nb, nb)
            )
            panel = jax.lax.linalg.triangular_solve(
                Lkk_b, Si, left_side=False, lower=True, transpose_a=True,
            )
            for i in range(k + 1, B):
                L[i][k] = panel[:, i - k - 1]
    zero = jnp.zeros((n_sub, nb, nb), A.dtype)
    rows = [
        jnp.concatenate([L[i][j] if j <= i else zero for j in range(B)],
                        axis=2)
        for i in range(B)
    ]
    out = jnp.concatenate(rows, axis=1)
    return out[:, :p, :p]


def use_blocked_tri_inv(n_sub: int) -> bool:
    """Blocked substitution is only worth it for LARGE batches: its per-step
    small matmuls are latency-bound, so at small batch (e.g. the coarse
    factor, n_sub=1) lax triangular_solve is the better choice."""
    return n_sub >= 8


def batched_tri_lower_inv(L: jnp.ndarray, nb: int = 64) -> jnp.ndarray:
    """Explicit inverse of a batch of lower-triangular matrices via blocked
    forward substitution.

    Reformulated as nb-block substitution, all the cubic work of
    ``triangular_solve`` against the identity becomes square f64 matmuls
    plus B tiny diagonal-block solves.  Math is the standard column-block
    algorithm:

        X[j,j] = L[j,j]^{-1}
        X[i,j] = -L[i,i]^{-1} sum_{j<=k<i} L[i,k] X[k,j]   (i > j)

    L: (n_sub, p, p); returns (n_sub, p, p) with X @ L == I on the leading
    p x p (padding blocks are identity).  Cost: B^3/6 block matmuls.
    The block size nb=64 is not yet tuned on the GPU.
    """
    n_sub, p, _ = L.shape
    B = -(-p // nb)
    P = B * nb
    if P != p:
        # pad with identity diag so padded diagonal blocks stay invertible
        Lp = jnp.zeros((n_sub, P, P), L.dtype)
        Lp = Lp.at[:, :p, :p].set(L)
        Lp = Lp.at[:, jnp.arange(p, P), jnp.arange(p, P)].set(1.0)
        L = Lp
    # (n_sub, B, B, nb, nb) block view: blk[s, i, j] = L[s, i-block, j-block]
    blk = L.reshape(n_sub, B, nb, B, nb).transpose(0, 1, 3, 2, 4)
    eye = jnp.broadcast_to(jnp.eye(nb, dtype=L.dtype), (n_sub, B, nb, nb))
    Dinv = jax.lax.linalg.triangular_solve(
        blk[:, jnp.arange(B), jnp.arange(B)], eye,
        left_side=True, lower=True,
    )  # (n_sub, B, nb, nb)
    # X block rows, filled top-down; X[i, j] for j <= i
    X = [[None] * B for _ in range(B)]
    for i in range(B):
        for j in range(i + 1):
            if i == j:
                X[i][j] = Dinv[:, i]
            else:
                acc = sum(
                    jnp.einsum("spq,sqr->spr", blk[:, i, k], X[k][j])
                    for k in range(j, i)
                )
                X[i][j] = -jnp.einsum("spq,sqr->spr", Dinv[:, i], acc)
    zero = jnp.zeros((n_sub, nb, nb), L.dtype)
    rows = [
        jnp.concatenate([X[i][j] if j <= i else zero for j in range(B)],
                        axis=2)
        for i in range(B)
    ]
    out = jnp.concatenate(rows, axis=1)
    return out[:, :p, :p]


def _newton_refine(A: jnp.ndarray, X: jnp.ndarray, steps: int) -> jnp.ndarray:
    """Newton–Schulz refinement X <- X (2I - A X).

    Squares the inverse residual per step.  This is the batched analogue of
    the reference's blockwise iterative refinement
    (dune/ddm/eigensolvers/umfpack.hh:42-129), done once at setup so the
    per-iteration apply stays a single matmul.
    """
    for _ in range(steps):
        AX = jnp.einsum("spq,sqr->spr", A, X)
        X = 2.0 * X - jnp.einsum("spq,sqr->spr", X, AX)
    return X


def pack_inverse(inv: jnp.ndarray, store_dtype=None):
    """Wrap an explicit inverse batch in the apply-path container matching
    ``store_dtype`` (None -> f64 BatchedInverse, "dd" -> double-single pair,
    a dtype -> down-cast BatchedInverse)."""
    if store_dtype == "dd":
        h, l = dd_split(inv)
        return BatchedInverseDD(inv_hi=h, inv_lo=l)
    if store_dtype is not None:
        inv = inv.astype(store_dtype)
    return BatchedInverse(inv=inv)


def _f32_seed_inverse(A: jnp.ndarray, with_factor: bool = False):
    """f32 Cholesky inverse of an SPD batch, promoted to f64.

    The resulting inverse carries the full eps32*cond(A) error (~0.36
    Frobenius residual on the equilibrated contrast-1e6 flagship batch) and
    is only useful as a Newton seed.

    with_factor: form the product X = Li^T Li in F64 (from the f64-cast
    factor) and return (X, Li).  The f32 product of the plain variant
    carries an ELEMENTWISE fl32 rounding of X whose multiplicative error
    A dX reaches ~eps32 * cond(A) — measured on an unstructured L-shape:
    sigma(I - X A) ~ 40 from the f32 product alone while the factor's own
    whitened residual was 0.6 — so the accept path must use the f64
    product (one square f64 matmul per chunk) for the spectral test to
    mean anything."""
    A32 = A.astype(jnp.float32)
    L32 = jnp.linalg.cholesky(A32)
    eye = jnp.broadcast_to(jnp.eye(A.shape[-1], dtype=jnp.float32), A32.shape)
    Li = jax.lax.linalg.triangular_solve(L32, eye, left_side=True, lower=True)
    if with_factor:
        Li64 = Li.astype(A.dtype)
        X0 = jnp.einsum("sqp,sqr->spr", Li64, Li64)
        return X0, Li64
    X0 = jnp.einsum("sqp,sqr->spr", Li, Li, precision=HIGHEST)
    return X0.astype(A.dtype)


def _newton_step_resid(A: jnp.ndarray, X: jnp.ndarray):
    """One Newton–Schulz step X' = X (2I - A X) plus the Frobenius residual
    max_s ||I - A X_s||_F of the INPUT X (free: reuses the A X product)."""
    AX = jnp.einsum("spq,sqr->spr", A, X)
    E = jnp.eye(A.shape[-1], dtype=A.dtype)[None] - AX
    r = jnp.sqrt(jnp.max((E * E).sum((1, 2))))
    Xn = 2.0 * X - jnp.einsum("spq,sqr->spr", X, AX)
    return Xn, r


@lru_cache(maxsize=4)
def _newton_seed_jit():
    return jax.jit(_f32_seed_inverse, static_argnames=("with_factor",))


def _whitened_seed_resid_est(A: jnp.ndarray, Li: jnp.ndarray, k: int = 8):
    """Hutchinson estimate of max_s ||Li A Li^T - I||_F.

    This SYMMETRIC whitened residual W is the spectrum-relevant error
    measure for the seed X = Li^T Li: A X - I = Li^{-1} W Li (a similarity
    of W), so the preconditioned generalized Rayleigh quotients
    x^T X x / x^T A^{-1} x lie in [1+lam_min(W), 1+lam_max(W)] with
    max|lam(W)| <= ||W||_F.  The plain ||A X - I||_F is the
    same matrix measured through the similarity — inflated by up to
    cond(Li) — and rejected seeds whose actual spectral perturbation was
    tiny (measured: unstructured L-shape chunks read plain-resid >> 1
    with whitened resid well under preconditioner-grade rtol)."""
    p = A.shape[-1]
    V = jax.random.normal(jax.random.PRNGKey(0), (k, p), dtype=A.dtype)
    fro2 = jnp.zeros(A.shape[0], dtype=A.dtype)
    for i in range(k):  # unrolled; each probe is three fused passes
        v = V[i]
        # W v = Li (A (Li^T v)) - v ; Li^T v first:
        ltv = (Li * v[None, :, None]).sum(-2)     # (n_sub, p) = Li^T v
        altv = (A * ltv[:, None, :]).sum(-1)      # A Li^T v
        w = (Li * altv[:, None, :]).sum(-1) - v[None]  # Li (A Li^T v) - v
        fro2 = fro2 + (w * w).sum(-1)
    return jnp.sqrt(jnp.max(fro2 / k))


@lru_cache(maxsize=4)
def _whitened_seed_resid_jit():
    return jax.jit(_whitened_seed_resid_est, static_argnames=("k",))


def _plain_sigma_est(A: jnp.ndarray, X: jnp.ndarray,
                     iters: int = 10, nvec: int = 2):
    """Spectral-radius estimate of E = I - X A — the post-step verification
    of the computed-step Newton path.

    E is severely NONNORMAL in coordinates (||E||_2 ~ cond-inflated, an
    unstructured L-shape read 5.4e4 while the eigenvalues were ~0.5), but it is
    SELF-ADJOINT in the A-inner product: <Eu, v>_A = u^T A v - u^T A X A v
    is symmetric in (u, v).  Power iteration therefore runs with A-norms
    and an A-Rayleigh quotient, which converges like the symmetric case —
    a plain 2-norm power iteration reads the nonnormal transient instead
    of the spectrum and never accepts."""
    n_sub, p, _ = A.shape
    V = jax.random.normal(jax.random.PRNGKey(2), (nvec, n_sub, p),
                          dtype=A.dtype)

    def amul(v):
        return (A * v[:, None, :]).sum(-1)

    def emul(v, av):
        return v - (X * av[:, None, :]).sum(-1)

    sig = jnp.zeros(n_sub, A.dtype)
    for j in range(nvec):
        v = V[j]
        for _ in range(iters):
            av = amul(v)
            w = emul(v, av)
            aw = amul(w)
            na = jnp.sqrt(jnp.maximum((w * aw).sum(1, keepdims=True), 1e-300))
            v = w / na
        av = amul(v)
        w = emul(v, av)
        # A-Rayleigh quotient of the A-normalized iterate: <v, Ev>_A
        lam = jnp.abs((av * w).sum(1)) / jnp.maximum((v * av).sum(1), 1e-300)
        sig = jnp.maximum(sig, lam)
    return jnp.max(sig)


@lru_cache(maxsize=4)
def _plain_sigma_jit():
    return jax.jit(_plain_sigma_est, static_argnames=("iters", "nvec"))


def _seed_resid_est(A: jnp.ndarray, X: jnp.ndarray, k: int = 8):
    """Hutchinson estimate of max_s ||I - A X_s||_F via k Gaussian probes.

    E[||E v||^2] = ||E||_F^2 for v ~ N(0, I); each probe is two
    multiply+reduce matvecs (the full residual would be a square f64
    matmul — the whole point of accepting the seed is to skip those).  Fixed key: deterministic under jit."""
    p = A.shape[-1]
    V = jax.random.normal(jax.random.PRNGKey(0), (k, p), dtype=A.dtype)
    fro2 = jnp.zeros(A.shape[0], dtype=A.dtype)
    for i in range(k):  # unrolled; each probe is two fused passes
        v = V[i]
        xv = (X * v[None, None, :]).sum(-1)       # (n_sub, p) = X v
        Axv = (A * xv[:, None, :]).sum(-1)        # (n_sub, p) = A X v
        e = Axv - v[None]
        fro2 = fro2 + (e * e).sum(-1)
    return jnp.sqrt(jnp.max(fro2 / k))


@lru_cache(maxsize=4)
def _seed_resid_jit():
    return jax.jit(_seed_resid_est, static_argnames=("k",))


@lru_cache(maxsize=4)
def _newton_step_jit():
    return jax.jit(_newton_step_resid)


# Stop once the residual of the step INPUT drops below NEWTON_RTOL: the
# step's output residual is then ~rtol^2 (measured contraction on the bench
# batch is even faster: 3.5e-6 in -> 9.3e-12 out), i.e. at the f64
# pipeline's own floor (7e-12).  Env-overridable for experiments.
NEWTON_RTOL = 1e-6
NEWTON_MAX_STEPS = 8


def newton_inverse_batched(A: jnp.ndarray, store_dtype=None,
                           rtol: float | None = None,
                           max_steps: int | None = None):
    """Explicit SPD inverse via f32 Cholesky seed + f64 Newton–Schulz.

    Seeds from the f32 factorization and refines with matmul-only Newton
    steps to the same ~7e-12 inverse residual as the f64 Cholesky pipeline.
    It was chosen where f64 Cholesky was slow; its time on the GPU against
    ``factor_batched(..., "cholesky", "inverse")`` is in PERF.md.

    Residual-controlled per chunk with an automatic exact-f64 fallback: a
    chunk whose seed diverges (e.g. f32 Cholesky NaN on a subdomain with
    cond >~ 1/eps32) is recomputed through the f64 Cholesky pipeline, so
    the result NEVER depends on Newton converging.  This is unlike the
    failed dd-arithmetic construction (see note in factor_batched): the
    refinement here runs in true backend f64 (eps ~ 2^-48), whose floor
    eps*cond stays well below 1 for any subdomain the f64 pipeline itself
    could factor.

    Returns the packed apply-path container (see pack_inverse).
    """
    import os

    if rtol is None:
        rtol = float(os.environ.get("DDM_NEWTON_RTOL", NEWTON_RTOL))
    if max_steps is None:
        max_steps = int(os.environ.get("DDM_NEWTON_MAX_STEPS",
                                       NEWTON_MAX_STEPS))

    seed_accept = os.environ.get("DDM_NEWTON_SEED_ACCEPT", "1") == "1"

    def _chunk(Ac):
        if seed_accept and max_steps > 0:
            # tier 1 (the r3c fast path, kept bit-identical for the
            # structured benches): the cheap f32-product seed, accepted on
            # the plain Frobenius estimate.  Chunks that fail it (high
            # cond / nonnormality) escalate to the spectral machinery.
            X32 = _newton_seed_jit()(Ac)
            r32 = float(_seed_resid_jit()(Ac, X32))
            if np.isfinite(r32) and r32 < rtol:
                return X32
            X, Li = _newton_seed_jit()(Ac, with_factor=True)
            if rtol >= 1e-2:
                # preconditioner-grade stop: the spectral radius of
                # I - X A measured on the ACTUAL X in the A-inner product
                # (_plain_sigma_est; E is A-self-adjoint) — the plain
                # ||A X - I||_F is cond-inflated by nonnormality (measured
                # 5.4e4 plain vs ~0.6 spectral on the unstructured audit
                # chunks), and a factor-based whitened estimate misses the
                # product rounding of X itself
                sig = float(_plain_sigma_jit()(Ac, X))
                if os.environ.get("DDM_NEWTON_DEBUG"):
                    print(f"[newton] chunk seed sigma {sig:.3g} "
                          f"(rtol {rtol:.3g})", flush=True)
                if np.isfinite(sig) and sig < rtol:
                    return X
                if np.isfinite(sig) and sig < 0.9:
                    # Newton squares the multiplicative-error spectrum
                    # (eigs of I - X A are real; sigma -> sigma^2 per
                    # step), so the required step count is computable —
                    # the plain Frobenius monitor reads cond-inflated
                    # values and bails spuriously (L-shape: 5.4e4 ->
                    # 2.2e6 readings while the true spectrum converged)
                    import math

                    k = max(1, math.ceil(math.log2(
                        math.log(max(rtol, 1e-12)) / math.log(sig))))
                    for _ in range(min(k, max_steps)):
                        X, _ = _newton_step_jit()(Ac, X)
                    sig_f = float(_plain_sigma_jit()(Ac, X))
                    if os.environ.get("DDM_NEWTON_DEBUG"):
                        print(f"[newton] {min(k, max_steps)} computed "
                              f"steps -> sigma {sig_f:.3g}", flush=True)
                    if np.isfinite(sig_f) and sig_f < rtol:
                        return X
                    # verification failed: escalate below
                    X = None
                else:
                    # f32-factor NaN or sigma >= 0.9 (Newton would not
                    # contract usefully): escalate straight to the staged /
                    # exact fallbacks — the plain-monitored loop reads the
                    # nonnormal norm and cannot help at this grade
                    X = None
            else:
                # exact-grade stop: keep the plain forward residual (the
                # documented ~1e-6/7e-12 inverse-quality semantics)
                r0 = float(_seed_resid_jit()(Ac, X))
                if np.isfinite(r0) and r0 < rtol:
                    return X
                if os.environ.get("DDM_NEWTON_DEBUG"):
                    print(f"[newton] chunk seed resid {r0:.3g} "
                          f"(rtol {rtol:.3g}, plain)", flush=True)
        else:
            X = _newton_seed_jit()(Ac)
        if X is None and rtol >= 1e-2:
            # staged-whitening fallback: X = M^T M with M from the
            # mixed-precision staged whitener — each stage is one f32
            # Cholesky plus f64 SQUARE matmuls, for chunks whose cond
            # exceeds the single-f32-factor reach (~1/eps32).
            # Aw = M A M^T = I + E with ||E||_F <= WHITEN_RTOL, and
            # I - (M^T M) A is similar to -E, so sigma <= rtol by
            # construction; the cheap A-spectral verify guards the f64
            # product rounding.
            M, _, _ = staged_whiten_batched(Ac)
            Xs = jnp.einsum("sqp,sqr->spr", M, M)
            sig_s = float(_plain_sigma_jit()(Ac, Xs))
            if os.environ.get("DDM_NEWTON_DEBUG"):
                print(f"[newton] staged-whiten fallback sigma {sig_s:.3g}",
                      flush=True)
            if np.isfinite(sig_s) and sig_s < rtol:
                return Xs
        if X is None:
            if os.environ.get("DDM_NEWTON_DEBUG"):
                print("[newton] chunk fell back to exact f64 cholesky "
                      "(post-step verify failed)", flush=True)
            return factor_batched_jit("cholesky", "inverse", 0)(Ac).inv
        # Seed-accept rationale: the raw f32 seed is multiplicatively
        # exact, X = A^-1 (I+E) with the error's NORM read off the
        # symmetric whitened residual above; at preconditioner-grade rtol
        # 4e-1 accepting it skips the 2-square-matmul Newton step entirely
        # with the same GMRES iterations.  A
        # Hutchinson under-estimate can only admit a slightly rougher
        # preconditioner (rate, not correctness); exact-grade rtol 1e-6 is
        # never met by the seed, so the default path is unchanged.  Opt
        # out: DDM_NEWTON_SEED_ACCEPT=0.
        prev = np.inf
        for step in range(max_steps):
            X, r = _newton_step_jit()(Ac, X)
            rv = float(r)
            if os.environ.get("DDM_NEWTON_DEBUG"):
                print(f"[newton] step {step} resid {rv:.3g}", flush=True)
            if rv < rtol:
                return X
            if not np.isfinite(rv) or (rv >= prev and rv > 1.0):
                break  # seed divergent for some subdomain in this chunk
            prev = rv
        if os.environ.get("DDM_NEWTON_DEBUG"):
            print("[newton] chunk fell back to exact f64 cholesky",
                  flush=True)
        # exact fallback: the measured-safe f64 Cholesky pipeline
        return factor_batched_jit("cholesky", "inverse", 0)(Ac).inv

    inv = chunked_batch(_chunk, A)
    return pack_inverse(inv, store_dtype)


def _whiten_stage(Aw: jnp.ndarray, delta: jnp.ndarray):
    """One stage of mixed-precision congruence whitening.

    Factors the current iterate in f32 (with a per-subdomain relative
    diagonal shift ``delta`` for Cholesky safety), applies the inverse factor
    as an EXACT f64 congruence, and reports the per-subdomain whitening
    residual ||M1 Aw M1^T - I||_F.  Subdomains whose f32 factor is not
    finite keep M1 = I (their shift is escalated by the host driver).
    """
    n_sub, p, _ = Aw.shape
    eye = jnp.eye(p, dtype=Aw.dtype)
    scale = jnp.mean(jnp.abs(jnp.diagonal(Aw, axis1=1, axis2=2)), axis=1)
    A32 = (Aw + (delta * scale)[:, None, None] * eye[None]).astype(jnp.float32)
    L32 = jnp.linalg.cholesky(A32)
    eye32 = jnp.broadcast_to(jnp.eye(p, dtype=jnp.float32), A32.shape)
    Li32 = jax.lax.linalg.triangular_solve(
        L32, eye32, left_side=True, lower=True
    )
    M1 = Li32.astype(Aw.dtype)
    ok = jnp.isfinite(M1).all(axis=(1, 2))
    M1 = jnp.where(ok[:, None, None], M1, jnp.broadcast_to(eye, Aw.shape))
    Aw2 = jnp.einsum("spq,sqr->spr", M1, Aw)
    Aw2 = jnp.einsum("spq,srq->spr", Aw2, M1)
    Aw2 = 0.5 * (Aw2 + jnp.swapaxes(Aw2, 1, 2))
    E = Aw2 - eye[None]
    resid = jnp.sqrt((E * E).sum((1, 2)))
    return M1, Aw2, resid, ok


@lru_cache(maxsize=4)
def _whiten_stage_jit():
    return jax.jit(_whiten_stage)


def _whiten_probe(Areg: jnp.ndarray, n_probes: int = 8):
    """Stage-0 whitening factor + Hutchinson residual ESTIMATE, without
    forming Aw = M Areg M^T (two (p,p) f64 square matmuls).

    ||E||_F^2 = E_z ||E z||^2 for Rademacher z, so k probes estimate the
    residual with relative std ~ sqrt(2/k); the accept decision this feeds
    only controls the REFINEMENT's convergence rate — the generalized
    Rayleigh-Ritz consumes the (thin) whitened metric exactly either way —
    so estimator noise cannot bias the returned eigenpairs.
    """
    n_sub, p, _ = Areg.shape
    eye = jnp.eye(p, dtype=Areg.dtype)
    A32 = Areg.astype(jnp.float32)
    L32 = jnp.linalg.cholesky(A32)
    eye32 = jnp.broadcast_to(jnp.eye(p, dtype=jnp.float32), A32.shape)
    Li32 = jax.lax.linalg.triangular_solve(
        L32, eye32, left_side=True, lower=True
    )
    M1 = Li32.astype(Areg.dtype)
    ok = jnp.isfinite(M1).all(axis=(1, 2))
    M1 = jnp.where(ok[:, None, None], M1, jnp.broadcast_to(eye, Areg.shape))
    # E z = M1 Areg M1^T z - z, three thin f64 matmuls
    z = (jax.random.rademacher(
        jax.random.PRNGKey(0), (n_sub, p, n_probes), jnp.int8)
    ).astype(Areg.dtype)
    Ez = jnp.einsum("spq,sqk->spk", M1,
                    jnp.einsum("spq,sqk->spk", Areg,
                               jnp.einsum("sqp,sqk->spk", M1, z))) - z
    r2 = (Ez * Ez).sum(axis=(1, 2)) / n_probes
    resid = jnp.sqrt(jnp.maximum(r2, 0.0))
    return M1, jnp.where(ok, resid, jnp.inf)


@lru_cache(maxsize=4)
def _whiten_probe_jit():
    return jax.jit(_whiten_probe, static_argnames=("n_probes",))


def staged_whiten_estimate(Areg: jnp.ndarray, rtol: float | None = None):
    """Probe-accepted stage-0 whitening: returns ``(M, None, resid)`` when
    the estimated stage-0 residual meets ``rtol`` for every subdomain (the
    common case on the flagship pencils), skipping the Aw formation entirely; falls
    back to :func:`staged_whiten_batched` (which forms Aw and escalates
    stages) otherwise.  ``DDM_WHITEN_PROBE=0`` disables the probe path.
    """
    import os

    if rtol is None:
        rtol = float(os.environ.get("DDM_WHITEN_RTOL", WHITEN_RTOL))
    if os.environ.get("DDM_WHITEN_PROBE", "1") != "0":
        M1, r_dev = _whiten_probe_jit()(Areg)
        r = np.asarray(r_dev)
        if (r < rtol).all():
            return M1, None, r
    return staged_whiten_batched(Areg, rtol=rtol)


@lru_cache(maxsize=4)
def _compose_jit():
    return jax.jit(lambda M1, M: jnp.einsum("spq,sqr->spr", M1, M))


# Convergence target for staged whitening: the GEVP's generalized
# Rayleigh-Ritz uses the whitened metric EXPLICITLY (dense_gevp.py), so the
# residual only biases the refinement subspace by O(resid/gap) — loose
# tolerances change the RATE machinery, not the returned Ritz pairs.  On
# the flagship ring pencils 1e-2 accepts ONE f32 stage with the same GMRES
# iterations as 1e-3; pencils whose stage-0 residual exceeds it get further
# stages adaptively.  The value was tuned for speed on the first
# accelerator and is not yet re-measured on the GPU (ROADMAP A3).
# Env-overridable (DDM_WHITEN_RTOL).
WHITEN_RTOL = 1e-2
WHITEN_MAX_STAGES = 3


def staged_whiten_batched(Areg: jnp.ndarray, rtol: float | None = None,
                          max_stages: int | None = None):
    """Mixed-precision staged congruence whitening of an SPD batch.

    Returns ``(M, Aw, resid)`` with ``Aw = M Areg M^T = I + E``,
    ``resid[s] = ||E_s||_F <= rtol`` (after a per-subdomain exact-f64
    Cholesky fallback for any subdomain the staged scheme cannot whiten).

    An alternative to the GEVP's f64 Cholesky + triangular inverse: each
    stage is one f32 Cholesky/tri-solve plus three f64 SQUARE matmuls.
    One f32 stage cuts cond(A) from kappa to
    ~eps32*kappa, so two stages whiten even the near-singular ring pencils
    (cond 1e9-1e10) to ~1e-4; because every stage is an EXACT f64 congruence
    by *some* invertible factor, intermediate f32 inaccuracy (or a safety
    shift after an f32 Cholesky NaN) never biases the pencil — unlike the
    failed dd-Newton construction and the f32-Cholesky-whitener experiments
    recorded in CLAUDE.md, which needed the f32 factor itself to be accurate.
    """
    import os

    if rtol is None:
        rtol = float(os.environ.get("DDM_WHITEN_RTOL", WHITEN_RTOL))
    if max_stages is None:
        max_stages = int(os.environ.get("DDM_WHITEN_MAX_STAGES",
                                        WHITEN_MAX_STAGES))
    n_sub = Areg.shape[0]
    M = None
    Aw = Areg
    delta = np.zeros(n_sub)
    r = np.full(n_sub, np.inf)
    for _ in range(max_stages):
        M1, Aw, r_dev, ok_dev = _whiten_stage_jit()(Aw, jnp.asarray(delta))
        M = M1 if M is None else _compose_jit()(M1, M)
        r = np.asarray(r_dev)
        ok = np.asarray(ok_dev)
        if (r < rtol).all():
            return M, Aw, r
        # escalate the safety shift where the f32 factor failed outright;
        # clear it where the stage succeeded (the next stage re-factors the
        # already-whitened iterate)
        delta = np.where(ok, 0.0, np.maximum(delta * 100.0, 1e-6))
    bad = np.flatnonzero(r >= rtol)
    if bad.size:
        # exact fallback: the measured-safe f64 Cholesky pipeline on the
        # offending subdomains only
        idx = jnp.asarray(bad)
        Ab = Areg[idx]
        L = jnp.linalg.cholesky(Ab)
        if jax.default_backend() != "cpu" and use_blocked_tri_inv(bad.size):
            Li = batched_tri_lower_inv(L)
        else:
            eyeb = jnp.broadcast_to(
                jnp.eye(Ab.shape[-1], dtype=Ab.dtype), Ab.shape
            )
            Li = jax.lax.linalg.triangular_solve(
                L, eyeb, left_side=True, lower=True
            )
        Awb = jnp.einsum("spq,sqr->spr", Li, Ab)
        Awb = jnp.einsum("spq,srq->spr", Awb, Li)
        M = M.at[idx].set(Li)
        Aw = Aw.at[idx].set(0.5 * (Awb + jnp.swapaxes(Awb, 1, 2)))
        E = Awb - jnp.eye(Ab.shape[-1], dtype=Ab.dtype)[None]
        r[bad] = np.asarray(jnp.sqrt((E * E).sum((1, 2))))
    return M, Aw, r


def factor_batched(
    A: jnp.ndarray,
    solver_type: str = "lu",
    mode: str = "auto",
    refine_steps: int | None = None,
    store_dtype=None,
):
    """Factor a batch of dense subdomain matrices (n_sub, p, p).

    mode: "factors" keeps triangular factors, "inverse" forms explicit
    inverses (one matvec pass per apply, see BatchedInverse), "auto" picks
    "factors" on the CPU and "inverse" on an accelerator (their times on the
    GPU are in PERF.md).  refine_steps: Newton refinement steps for the
    inverse (default 0).  store_dtype: optionally down-cast the stored
    inverse (e.g. jnp.float32: halves the memory traffic per apply; the
    preconditioner stays a fixed linear operator, only its quality changes
    slightly — pair with Jacobi equilibration).
    """
    st = resolve_solver_type(solver_type)
    on_cpu = jax.default_backend() == "cpu"
    if mode == "auto":
        mode = "factors" if on_cpu else "inverse"
    if refine_steps is None:
        # Newton polish default off: the polished inverse was measured no
        # more accurate than the direct one at cond 1e7, and costs two
        # square matmuls
        refine_steps = 0
    def _pack_inverse(inv):
        return pack_inverse(inv, store_dtype)

    # NOTE: constructing the inverse ITSELF in dd arithmetic (f32 triangular
    # seed + dd Newton) was tried and FAILS for high-contrast subdomains:
    # any eps-precision construction floors at ||I - A X|| ~ eps_dd * cond
    # with eps_dd ~ 3e-7 (f32 accumulation), which is O(1) at cond 1e7.
    # Construction stays f64; only the APPLY uses dd (store_dtype="dd").
    if st == "cholesky":
        chol = jnp.linalg.cholesky(A)
        if mode == "inverse":
            if on_cpu or not use_blocked_tri_inv(A.shape[0]):
                eye = jnp.broadcast_to(
                    jnp.eye(A.shape[-1], dtype=A.dtype), A.shape
                )
                linv = jax.lax.linalg.triangular_solve(
                    chol, eye, left_side=True, lower=True
                )
            else:
                # blocked substitution: cubic work as f64 square matmuls
                linv = batched_tri_lower_inv(chol)
            inv = jnp.einsum("sqp,sqr->spr", linv, linv)  # L^{-T} L^{-1}
            inv = _newton_refine(A, inv, refine_steps)
            return _pack_inverse(inv)
        return BatchedCholesky(chol=chol)
    if st == "qr":
        q, r = jnp.linalg.qr(A)
        if mode == "inverse":
            eye = jnp.broadcast_to(jnp.eye(A.shape[-1], dtype=A.dtype), A.shape)
            rinv = jax.lax.linalg.triangular_solve(
                r, eye, left_side=True, lower=False
            )
            inv = jnp.einsum("spq,srq->spr", rinv, q)  # R^{-1} Q^T
            inv = _newton_refine(A, inv, refine_steps)
            return _pack_inverse(inv)
        return BatchedQR(q=q, r=r)
    lu, piv = jax.vmap(jax.scipy.linalg.lu_factor)(A)
    return BatchedLU(lu=lu, piv=piv)
