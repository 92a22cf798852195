"""Device-resident sparse matrices in padded ELL format (transposed layout).

Replaces DUNE-ISTL's ``BCRSMatrix`` (reference: used throughout, see SURVEY.md
§2.5).  Compressed-row storage with ragged rows defeats XLA's static shapes,
so the global operator is stored as **padded ELL**: every row holds
``m = max_row_nnz`` column/value slots, padding slots point at a dummy column
``n_rows`` with value 0.  SpMV is then a dense gather + reduction — fully
vectorizable with no dynamic shapes.

Layout: the device arrays are stored TRANSPOSED, shape ``(m, n)`` — slot-major
rather than row-major, so the long axis n is the contiguous minor dimension
(with m ~ 9 a row-major (n, m) layout puts a tiny dimension minor).  Same
data, same math — only the axis order differs.

The host-side :class:`EllPattern` is built once per sparsity pattern and maps
each element-assembly COO entry to its flat transposed ELL slot, so
(re-)assembly on device is a single ``scatter-add`` — this is what makes
Newton re-assembly (reference: twolevel_schwarz.hh:99-104 value re-add with
reused symbolics) a pure device op here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import os

import jax
import jax.numpy as jnp
import numpy as np


def tiled_take(xp: jnp.ndarray, idx: jnp.ndarray, tile: int = 128) -> jnp.ndarray:
    """Gather from a 1-D operand as a row gather plus a one-hot select.

    Reshapes ``xp`` into (n_t, tile) rows, row-gathers each index's tile,
    and selects the element with a fused one-hot multiply-reduce.  Costs
    ``tile`` elements of stream per index instead of one scattered element
    read; it was written for an accelerator whose 1-D gathers ran one
    element at a time.  Exact: pure data movement, same values.
    """
    n = xp.shape[0]
    n_t = -(-n // tile)
    x2 = jnp.pad(xp, (0, n_t * tile - n)).reshape(n_t, tile)
    t = (idx // tile).astype(jnp.int32)
    l = (idx % tile).astype(jnp.int32)
    rows = x2[t]  # (..., tile) — bandwidth row gather
    sel = (l[..., None] == jnp.arange(tile, dtype=jnp.int32)).astype(xp.dtype)
    return (rows * sel).sum(axis=-1)


# Tile width of tiled_take.  Tuned on the first accelerator, not yet
# measured on the GPU (ROADMAP A7).
_TILED_TILE = int(os.environ.get("DDM_TILED_GATHER_TILE", "32"))


def maybe_tiled_take(xp: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """1-D-operand gather: :func:`tiled_take` on an accelerator, the plain
    gather on CPU.  Exact either way (pure data movement).  Both routes'
    GPU times are in PERF.md.  ``DDM_TILED_GATHER=0`` reverts to the plain
    gather everywhere.

    Memory guard: the row-gather materializes an (idx.size, tile) stream,
    which a device with 128-wide tiles pads to 128 regardless of the tile
    width — very large index sets keep the plain gather, which is
    O(idx.size)."""
    import jax

    if (jax.default_backend() == "cpu"
            or os.environ.get("DDM_TILED_GATHER", "1") == "0"
            or idx.size * 128 * xp.dtype.itemsize > (2 << 30)):
        return xp[idx]
    return tiled_take(xp, idx, _TILED_TILE)


@jax.tree_util.register_dataclass
@dataclass
class SparseELL:
    """Device sparse matrix, padded ELL layout, slot-major (transposed).

    colsT: (m, n) int32, padding slots == n (dummy column)
    valsT: (m, n) float

    Stencil fast path (offsets/fix_rows, host-detected in
    :meth:`EllPattern.from_coo`): when the pattern is (mostly) structured,
    slot k's column ids are affine, ``col = row + offsets[k]``, and the
    gather becomes ``m`` contiguous shifted slices of x — pure
    bandwidth-bound copies.  Rows that deviate (grid boundary, ragged
    stencils) are listed in ``fix_rows`` and recomputed exactly with the
    general gather, then overwritten.  ``offsets is None`` (unstructured
    pattern, >10% misaligned rows) keeps the general gather path.
    """

    colsT: jnp.ndarray
    valsT: jnp.ndarray
    # static: per-slot affine column offset, or None for the general path
    offsets: tuple | None = field(default=None, metadata=dict(static=True))
    # (n_fix,) int32 rows where the affine pattern does not hold
    fix_rows: jnp.ndarray | None = None

    @property
    def n(self) -> int:
        return self.colsT.shape[1]

    @property
    def m(self) -> int:
        return self.colsT.shape[0]

    def _mv_general(self, x: jnp.ndarray) -> jnp.ndarray:
        if x.ndim == 1:
            xp = jnp.concatenate([x, jnp.zeros((1,), x.dtype)])
            return (self.valsT * maybe_tiled_take(xp, self.colsT)).sum(axis=0)
        xp = jnp.concatenate([x, jnp.zeros((1, x.shape[1]), x.dtype)])
        # (m, n, k) gather; contract over m
        return jnp.einsum("mn,mnk->nk", self.valsT, xp[self.colsT])

    def _mv_stencil(self, x: jnp.ndarray) -> jnp.ndarray:
        """Shift-and-multiply SpMV for affine patterns (see class docstring).

        Padding slots carry value 0, so the (arbitrary) vector entry a
        shifted read picks up there contributes nothing; misaligned rows are
        exactly recomputed below and overwritten."""
        n = self.n
        w = max(1, max(abs(int(d)) for d in self.offsets))
        pad = [(w, w)] + [(0, 0)] * (x.ndim - 1)
        xp = jnp.pad(x, pad)
        y = jnp.zeros_like(x)
        for k, d in enumerate(self.offsets):
            shifted = jax.lax.slice_in_dim(xp, w + int(d), w + int(d) + n, axis=0)
            vk = self.valsT[k]
            y = y + (vk[:, None] if x.ndim == 2 else vk) * shifted
        if self.fix_rows is not None and self.fix_rows.shape[0]:
            if x.ndim == 1:
                xz = jnp.concatenate([x, jnp.zeros((1,), x.dtype)])
                gathered = xz[self.colsT[:, self.fix_rows]]
                y_fix = (self.valsT[:, self.fix_rows] * gathered).sum(axis=0)
            else:
                xz = jnp.concatenate([x, jnp.zeros((1, x.shape[1]), x.dtype)])
                gathered = xz[self.colsT[:, self.fix_rows]]
                y_fix = jnp.einsum(
                    "mn,mnk->nk", self.valsT[:, self.fix_rows], gathered
                )
            y = y.at[self.fix_rows].set(y_fix)
        return y

    def mv(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x.  x: (n,) or (n, k)."""
        if self.offsets is not None:
            return self._mv_stencil(x)
        return self._mv_general(x)

    def diagonal(self) -> jnp.ndarray:
        row = jnp.arange(self.n)[None, :]
        return jnp.where(self.colsT == row, self.valsT, 0.0).sum(axis=0)

    def rows_dense_gather(self, rows: jnp.ndarray):
        """(vals, cols) of the given global rows, row-major:
        rows (...,) -> vals/cols (..., m).  Used by subdomain extraction."""
        vals = jnp.moveaxis(self.valsT[:, rows], 0, -1)
        cols = jnp.moveaxis(self.colsT[:, rows], 0, -1)
        return vals, cols


@dataclass
class EllPattern:
    """Host-side symbolic pattern + assembly scatter map.

    Attributes
    ----------
    n : matrix size
    m : padded row width (max nnz per row)
    cols : (n, m) int32 column ids, padding == n  (host, row-major view)
    coo2slot : (n_coo,) int64 — flat TRANSPOSED ELL slot (pos*n + row) for
               each COO entry passed to :meth:`from_coo`, in original order.
    """

    n: int
    m: int
    cols: np.ndarray
    coo2slot: np.ndarray
    rows_csr: np.ndarray  # (nnz,) unique-entry row ids (CSR order)
    cols_csr: np.ndarray  # (nnz,) unique-entry col ids (CSR order)
    slot_csr: np.ndarray  # (nnz,) transposed ELL slot of each unique entry
    # stencil fast path (SparseELL docstring): per-slot modal column offset
    # + rows deviating from it; None when >10% of rows deviate
    offsets: tuple | None = None
    fix_rows: np.ndarray | None = None

    @staticmethod
    def _aligned_slots(urows, ucols, row_nnz, n: int, m_packed: int):
        """Offset-aligned slot assignment (diagonal/DIA-style ELL).

        Entries whose column offset ``col - row`` is common across the
        matrix get the slot dedicated to that offset — then slot k's column
        ids are exactly ``row + offsets[k]`` wherever present, and SpMV slot
        reads become contiguous shifted slices for EVERY row (grid-boundary
        rows simply leave their missing-neighbour slots as padding).  Rare
        offsets (unstructured regions) pack into extra trailing slots and
        their rows are recomputed exactly via ``fix_rows``.  Returns
        (ent_slot, m, offsets, fix_rows) or None when the pattern is not
        offset-structured (falls back to packed ELL)."""
        off = ucols - urows
        ovals, oinv, ocounts = np.unique(
            off, return_inverse=True, return_counts=True
        )
        aligned_sel = (ocounts >= max(32, 0.05 * n)) & (
            np.abs(ovals) <= max(1, n // 2)
        )
        n_aligned = int(aligned_sel.sum())
        if not (0 < n_aligned <= 32):
            return None
        slot_of_oval = np.full(ovals.size, -1, np.int64)
        slot_of_oval[aligned_sel] = np.arange(n_aligned)
        ent_slot = slot_of_oval[oinv]
        extra = ent_slot < 0
        if extra.any():
            erows = urows[extra]
            er_nnz = np.bincount(erows, minlength=n)
            n_extra = int(er_nnz.max())
            estart = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(er_nnz, out=estart[1:])
            # uniq order is row-major, so extras within a row are contiguous
            pos_extra = np.arange(erows.size) - estart[erows]
            ent_slot[extra] = n_aligned + pos_extra
            fix_rows = np.unique(erows).astype(np.int32)
        else:
            n_extra = 0
            fix_rows = np.zeros((0,), np.int32)
        m = n_aligned + n_extra
        # reject when alignment inflates storage or fix-up work too much
        if m > m_packed + 8 or fix_rows.size > 0.1 * n:
            return None
        offsets = tuple(int(d) for d in ovals[aligned_sel]) + (0,) * n_extra
        return ent_slot, m, offsets, fix_rows

    @staticmethod
    def from_coo(rows: np.ndarray, cols: np.ndarray, n: int) -> "EllPattern":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        key = rows * n + cols
        uniq, inverse = np.unique(key, return_inverse=True)
        urows = uniq // n
        ucols = uniq % n
        row_nnz = np.bincount(urows, minlength=n)
        m_packed = int(row_nnz.max()) if row_nnz.size else 1
        aligned = EllPattern._aligned_slots(urows, ucols, row_nnz, n, m_packed)
        if aligned is not None:
            ent_slot, m, offsets, fix_rows = aligned
        else:
            row_start = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(row_nnz, out=row_start[1:])
            ent_slot = np.arange(uniq.size) - row_start[urows]
            m, offsets, fix_rows = m_packed, None, None
        slot = ent_slot * n + urows  # transposed flat slot
        ell_cols = np.full((n, m), n, dtype=np.int32)
        ell_cols[urows, ent_slot] = ucols
        return EllPattern(
            n=n,
            m=m,
            cols=ell_cols,
            coo2slot=slot[inverse],
            rows_csr=urows,
            cols_csr=ucols,
            slot_csr=slot,
            offsets=offsets,
            fix_rows=fix_rows,
        )

    def _ell_meta(self) -> dict:
        return dict(
            offsets=self.offsets,
            fix_rows=None if self.offsets is None
            else jnp.asarray(self.fix_rows),
        )

    # -- device-side assembly ------------------------------------------------
    def assemble(self, coo_vals: jnp.ndarray) -> SparseELL:
        """Scatter-add COO values (in from_coo order) into a SparseELL."""
        flat = jnp.zeros((self.m * self.n,), coo_vals.dtype)
        flat = flat.at[jnp.asarray(self.coo2slot)].add(coo_vals.reshape(-1))
        return SparseELL(
            colsT=jnp.asarray(self.cols.T),
            valsT=flat.reshape(self.m, self.n),
            **self._ell_meta(),
        )

    def from_scipy_vals(self, sp_csr) -> SparseELL:
        """Build a SparseELL carrying the values of a scipy CSR matrix with
        the same pattern (host path, used in tests)."""
        import scipy.sparse as sps

        a = sps.csr_matrix(sp_csr)
        vals = np.zeros((self.m * self.n,))
        vals[self.slot_csr] = np.asarray(a[self.rows_csr, self.cols_csr]).ravel()
        return SparseELL(
            colsT=jnp.asarray(self.cols.T),
            valsT=jnp.asarray(vals.reshape(self.m, self.n)),
            **self._ell_meta(),
        )

    def to_scipy(self, ell: SparseELL):
        import scipy.sparse as sps

        vals = np.asarray(ell.valsT).reshape(-1)[self.slot_csr]
        return sps.csr_matrix(
            (vals, (self.rows_csr, self.cols_csr)), shape=(self.n, self.n)
        )


def jacobi_equilibrate(ell: SparseELL, b: jnp.ndarray):
    """Symmetric Jacobi equilibration: A' = D^{-1/2} A D^{-1/2}, b' = D^{-1/2} b.

    Compresses the dynamic range of high-contrast coefficient problems (the
    reference's heterogeneous test cases have 1e6+ contrast) so the f32
    fast paths keep full effective precision.  The
    solution transforms back as x = D^{-1/2} x'; returns (A', b', scale) with
    ``scale = D^{-1/2}``.  Iteration counts of Jacobi-equilibrated runs match
    the unequilibrated reference solves to within an iteration in practice
    (the preconditioned operators are similar).
    """
    diag = ell.diagonal()
    scale = jnp.where(diag > 0, 1.0 / jnp.sqrt(jnp.abs(diag)), 1.0)
    sp = jnp.concatenate([scale, jnp.zeros((1,), scale.dtype)])
    valsT = ell.valsT * scale[None, :] * sp[ell.colsT]
    return dataclasses.replace(ell, valsT=valsT), b * scale, scale


def eliminate_dirichlet(
    ell: SparseELL, dmask: jnp.ndarray, symmetric: bool = True
) -> SparseELL:
    """Symmetric Dirichlet elimination on ELL values.

    Mirrors the reference semantics (examples/pdelab_helper.hh:33-46):
    Dirichlet rows become identity rows; with ``symmetric``, Dirichlet columns
    in non-Dirichlet rows are zeroed.  ``dmask``: (n,) bool/0-1.
    """
    n = ell.n
    d = dmask.astype(bool)
    dp = jnp.concatenate([d, jnp.zeros((1,), bool)])  # padding col never dirichlet
    row_d = d[None, :]
    col_d = dp[ell.colsT]
    is_diag = ell.colsT == jnp.arange(n)[None, :]
    valsT = ell.valsT
    valsT = jnp.where(row_d, jnp.where(is_diag, 1.0, 0.0), valsT)
    if symmetric:
        valsT = jnp.where(~row_d & col_d, 0.0, valsT)
    return dataclasses.replace(ell, valsT=valsT)
