"""Device-side extraction of batched dense subdomain matrices.

Turns the global ELL operator into the overlapping subdomain ("Dirichlet")
matrices A_dir of the reference (examples/pdelab_helper.hh:134-138 +
CreateMatrix/AddMatrixDataHandle, dune/ddm/datahandles.hh:436-591): row p of
subdomain k is global row sub2glob[k, p] with entries whose columns fall
outside the subdomain dropped.  Because the global matrix is fully assembled,
every extracted row carries the complete global values — the same result the
reference obtains by summing per-rank contributions over the overlap
interface.

The extraction is one batched scatter through the host-precomputed
``local_cols`` map (core/indexmaps.py:extraction_map) and is jittable, so
Newton-style matrix refreshes re-extract on device at full HBM bandwidth.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from ..core.mesh import batched
from ..core.sparse import SparseELL


@lru_cache(maxsize=32)
def _rect_stencil_meta(meta, offsets):
    """Host: (decomp, window_masks) for the scatter-free rect extraction, or
    None when an offset does not decompose into small canvas steps."""
    from ..core.structured import _rect_window_masks, rect_offset_decomp

    decomp = rect_offset_decomp(offsets, meta)
    if decomp is None:
        return None
    return decomp, _rect_window_masks(decomp, meta)


@lru_cache(maxsize=32)
def _rect_dense_jit(meta, offsets, unit_padding_diag: bool):
    """One jitted executable for the rect extraction: eagerly it is ~90
    dispatches (9 rect_gathers x pad/slice/reshape each) — jitted it is one
    call."""
    import jax

    from ..core.structured import rect_dense_from_stencil

    decomp, wmasks = _rect_stencil_meta(meta, offsets)
    return jax.jit(lambda valsT, valid: rect_dense_from_stencil(
        valsT, valid, meta, decomp, wmasks,
        unit_padding_diag=unit_padding_diag,
    ))


@lru_cache(maxsize=32)
def _rect_streams_jit(meta, offsets):
    import jax

    from ..core.structured import rect_slot_streams

    decomp, wmasks = _rect_stencil_meta(meta, offsets)
    return jax.jit(lambda valsT, valid: rect_slot_streams(
        valsT, valid, meta, decomp, wmasks,
    ))


@lru_cache(maxsize=32)
def _rect_place_jit(meta, offsets, unit_padding_diag: bool):
    import jax

    from ..core.structured import canvas_local_offsets, rect_dense_place

    decomp, _ = _rect_stencil_meta(meta, offsets)
    offs = tuple(canvas_local_offsets(decomp, meta))
    return jax.jit(lambda G, valid: rect_dense_place(
        G, valid, list(offs), unit_padding_diag=unit_padding_diag,
    ))


def _extract_oneshot_budget() -> int:
    """Byte budget above which the extraction's HBM-heavy stage runs in
    subdomain slabs.  Env-tunable so tests can force the chunked/donated
    paths at CPU sizes (the slabbed paths engage only above 8 GB
    otherwise)."""
    import os

    return int(os.environ.get("DDM_EXTRACT_ONESHOT_BYTES", 8 << 30))


def _rect_extract(ell, valid, rect, unit_padding_diag: bool):
    """Canvas extraction, one-shot when the band array fits HBM, else the
    gather stage runs full-batch (small) and the HBM-heavy placement stage
    runs in subdomain slabs (one compile; the 3-D bench's
    (512, 1000, 1001) one-shot band exhausted a 16 GB device)."""
    from ..solvers.direct import batch_chunk_size, chunked_batch

    n_sub, n_pad = valid.shape
    # placement holds band + dense + update double-buffers: ~4 batch-sized
    # f64 temporaries
    one_shot_ok = n_sub * n_pad * n_pad * 8 * 4 <= _extract_oneshot_budget()
    if one_shot_ok:
        fn = _rect_dense_jit(rect, ell.offsets, unit_padding_diag)
        return batched(fn(ell.valsT, valid))
    G = _rect_streams_jit(rect, ell.offsets)(ell.valsT, valid)
    place = _rect_place_jit(rect, ell.offsets, unit_padding_diag)
    chunk = batch_chunk_size(n_pad, 8, live_buffers=6)
    Gt = jnp.moveaxis(G, 0, 1)
    fn = lambda Gc, v: place(jnp.moveaxis(Gc, 0, 1), v)  # noqa: E731
    # chunked_batch fills a preallocated batch in place (donated updates)
    # when unsharded, and re-commits chunks to the mesh sharding otherwise
    return batched(chunked_batch(fn, Gt, valid, chunk=chunk))


def rect_extract_ok(ell: SparseELL, rect, n_pad: int) -> bool:
    """True when the scatter-free rect stencil extraction applies (callers
    may then skip building/uploading the extraction_map entirely)."""
    return (
        rect is not None
        and ell.offsets is not None
        and rect.n_pad == n_pad
        and (ell.fix_rows is None or ell.fix_rows.shape[0] == 0)
        and _rect_stencil_meta(rect, ell.offsets) is not None
    )


def extract_subdomain_dense(
    ell: SparseELL,
    sub2glob: jnp.ndarray,  # (n_sub, n_pad) int32, pad == n_glob
    valid: jnp.ndarray,  # (n_sub, n_pad) bool
    local_cols: jnp.ndarray | None,  # (n_sub, n_pad, m) int32, dummy == n_pad
    unit_padding_diag: bool = True,
    rect=None,  # RectMeta of the canvas topo, when available
) -> jnp.ndarray:
    """Returns A_sub (n_sub, n_pad, n_pad) dense.

    Padding rows/cols are zero except unit diagonal (so the batch factors
    cleanly).

    With ``rect`` (the topology's canvas RectMeta) and an offset-aligned
    stencil operator, dispatches to the scatter-free diagonal-placement
    formulation (core/structured.py:rect_dense_from_stencil) — the general
    path below pays a ~n_sub*n_pad*m element scatter.
    """
    if rect_extract_ok(ell, rect, sub2glob.shape[1]):
        return _rect_extract(ell, valid, rect, bool(unit_padding_diag))
    if local_cols is None:
        raise ValueError(
            "general extraction path needs local_cols (extraction_map); "
            "None is only valid when the rect stencil fast path applies"
        )
    n_sub, n_pad = sub2glob.shape
    # the (n_slab, n_pad, n_pad+1) scatter target is the HBM-heavy buffer —
    # chunk the subdomain batch through it when the one-shot would not fit
    # (same rule as the canvas placement stage; at the 3-D bench the
    # 512 x 1000 x 1001 f64 one-shot exhausted a 16 GB device)
    if n_sub * n_pad * n_pad * 8 * 4 > _extract_oneshot_budget():
        from ..solvers.direct import batch_chunk_size, chunked_batch

        chunk = batch_chunk_size(n_pad, 8, live_buffers=6)
        fn = lambda s, v, lc: _general_slab_jit()(  # noqa: E731
            ell, s, v, lc, bool(unit_padding_diag)
        )
        return batched(chunked_batch(
            fn, sub2glob, valid, local_cols, chunk=chunk,
        ))
    return _general_slab_jit()(
        ell, sub2glob, valid, local_cols, bool(unit_padding_diag)
    )


def _general_slab_jit():
    """Jitted general extraction: one executable, so no batch-sized
    intermediate of the scatter chain outlives the call."""
    import jax

    global _GEN_SLAB_JIT
    if "_GEN_SLAB_JIT" not in globals():
        _GEN_SLAB_JIT = jax.jit(_general_extract_slab, static_argnums=4)
    return _GEN_SLAB_JIT


def _general_extract_slab(ell, sub2glob, valid, local_cols,
                          unit_padding_diag: bool):
    n_sub, n_pad = sub2glob.shape
    n = ell.n
    rows = jnp.minimum(sub2glob, n - 1)
    vals, _ = ell.rows_dense_gather(rows)  # (n_sub, n_pad, m)
    vals = vals * valid[:, :, None]
    A = batched(jnp.zeros((n_sub, n_pad, n_pad + 1), vals.dtype))
    k_idx = jnp.arange(n_sub)[:, None, None]
    p_idx = jnp.arange(n_pad)[None, :, None]
    A = A.at[k_idx, p_idx, local_cols].add(vals)
    A = A[..., :n_pad]
    if unit_padding_diag:
        diag = jnp.where(valid, 0.0, 1.0)
        A = A + jnp.eye(n_pad, dtype=A.dtype)[None, :, :] * diag[:, :, None]
    return A


def gather_subdomain(x: jnp.ndarray, sub2glob: jnp.ndarray) -> jnp.ndarray:
    """Global (n,) or (n, k) -> subdomain-local (n_sub, n_pad[, k]);
    the device analogue of copyOwnerToAll restriction (schwarz.hh:122-125)."""
    pad_shape = (1,) + x.shape[1:]
    xp = jnp.concatenate([x, jnp.zeros(pad_shape, x.dtype)])
    if x.ndim == 1:
        # 1-D-operand gather: tiled on an accelerator, plain on the CPU
        # (core/sparse.py:maybe_tiled_take)
        from ..core.sparse import maybe_tiled_take

        return maybe_tiled_take(xp, sub2glob)
    return xp[sub2glob]


def scatter_add_subdomain_shard(
    x_loc: jnp.ndarray, dualT: jnp.ndarray, axis: str, n_sub_full: int
) -> jnp.ndarray:
    """Sharded gather-dual scatter-add: embed the device-local subdomain
    slab into the full flat batch (one dynamic_update_slice into zeros), run
    the same (K, n) gather-dual as the unsharded path, and ``psum`` the
    partial sums.  Keeps the gather-dual formulation of the unsharded path
    under multi-device execution."""
    import jax

    trail = x_loc.shape[2:]
    n_loc, n_pad = x_loc.shape[:2]
    flat = jnp.zeros((n_sub_full * n_pad + 1,) + trail, x_loc.dtype)
    shard = jax.lax.axis_index(axis)
    flat = jax.lax.dynamic_update_slice_in_dim(
        flat, x_loc.reshape((-1,) + trail), shard * (n_loc * n_pad), axis=0
    )
    if not trail:
        from ..core.sparse import maybe_tiled_take

        return jax.lax.psum(maybe_tiled_take(flat, dualT).sum(axis=0), axis)
    return jax.lax.psum(flat[dualT].sum(axis=0), axis)


def scatter_add_subdomain(
    x_sub: jnp.ndarray, sub2glob: jnp.ndarray, n_glob: int,
    dualT: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Subdomain-local (n_sub, n_pad[, k]) -> global (n[, k]) by summation;
    the device analogue of addOwnerCopyToOwnerCopy (schwarz.hh:138-142).

    With ``dualT`` (core/indexmaps.py:dual_scatter_map, (K, n) int32) the
    scatter-add is computed as its gather dual, which was much faster
    than ``.at[].add`` on the first accelerator this code ran on; it is not
    yet timed against ``.at[].add`` on the GPU (ROADMAP A7)."""
    trail = x_sub.shape[2:]
    if dualT is not None:
        flat = jnp.concatenate(
            [x_sub.reshape((-1,) + trail),
             jnp.zeros((1,) + trail, x_sub.dtype)]
        )
        if not trail:
            from ..core.sparse import maybe_tiled_take

            return maybe_tiled_take(flat, dualT).sum(axis=0)
        return flat[dualT].sum(axis=0)
    out = jnp.zeros((n_glob + 1,) + trail, x_sub.dtype)
    out = out.at[sub2glob.reshape(-1)].add(x_sub.reshape((-1,) + trail))
    return out[:n_glob]
