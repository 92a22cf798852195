"""N-dimensional box-canvas fast path: the 3-D (and general N-D)
generalization of the structured 2-D rect canvas (core/structured.py).

On structured grids with uniform block partitions every overlapping
subdomain is an axis-aligned BOX of the dof grid; re-laying all subdomains
on a uniform tile anchored on a per-axis pitch grid turns the subdomain
gather/scatter and the dense stencil extraction into pure layout transforms
(pad / slice / reshape / transpose), exactly as the 2-D rect canvas does —
the machinery that was first confined to 2-D.  See structured.py's
module docstring for the rationale; everything here is the same
algorithm with per-axis loops instead of hard-coded row/column pairs.

The public entry points in structured.py (rect_gather, rect_scatter_add,
the *_shard variants, rect_offset_decomp, rect_dense_from_stencil) dispatch
to this module when the topology's canvas meta is a :class:`BoxMeta`, so
every consumer (Schwarz/Galerkin applies, dense extraction, pair-shift
coarse matrix) gains the 3-D fast path without changes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp
from jax import lax


@dataclass(frozen=True)
class BoxMeta:
    """Host-side static description of a uniform N-D box-canvas layout.

    All fields are Python ints/tuples; device code built from a BoxMeta
    traces to static slices/reshapes only.  Axis order is slowest..fastest
    (matching row-major flat dof ids).
    """

    dims: tuple     # dof grid dims per axis
    tile: tuple     # canvas tile dims per axis (max box extent)
    n_pad: int      # padded local size (>= prod(tile))
    margin: tuple   # padded-grid coordinate of dof 0 per axis
    padded: tuple   # padded grid dims per axis
    g: tuple        # number of anchor runs per axis (parity factors)
    pitch: tuple    # min anchor spacing per axis (informational)
    nparts: tuple   # subdomain grid dims per axis
    base: tuple     # anchor of part 0 per axis, padded-grid coords
    # per-group: (counts per axis, window origin per axis, subdomain ids
    # tiled row-major over the group's part grid, window stride per axis)
    groups: tuple
    perm: tuple     # inverse permutation to subdomain order
    # per-subdomain valid box in tile coords, ((start per axis), (extent per
    # axis)) nested tuples — EMPTY when no mask is needed.  With non-uniform
    # partitions, interior boxes can be SMALLER than the tile, so their
    # windows read real neighbouring dof values into invalid slots; the
    # uniform-pitch case only ever read out-of-grid zeros there and needs
    # no mask.
    starts: tuple = ()
    exts: tuple = ()

    @property
    def ndim(self) -> int:
        return len(self.dims)


def _subdomain_boxes(topo, dims):
    """Host: per-subdomain (lo, hi) box bounds, or None when any subdomain's
    dof set is not a dense row-major box scan of the grid."""
    nd = len(dims)
    n_sub = topo.n_sub
    lo = np.zeros((n_sub, nd), np.int64)
    ext = np.zeros((n_sub, nd), np.int64)
    for k in range(n_sub):
        ids = topo.sub2glob[k][topo.valid[k]].astype(np.int64)
        if ids.size == 0 or np.any(np.diff(ids) <= 0):
            return None
        coords = np.stack(np.unravel_index(ids, dims), axis=1)  # (sz, nd)
        c_lo = coords.min(axis=0)
        c_hi = coords.max(axis=0)
        h = c_hi - c_lo + 1
        if int(np.prod(h)) != ids.size:
            return None
        # dense row-major scan check: first/last match and size matches a
        # box; ids strictly increasing + within-bounds coords => the set is
        # exactly the box scan iff it has the box's size and extremes
        expect_first = np.ravel_multi_index(c_lo, dims)
        expect_last = np.ravel_multi_index(c_hi, dims)
        if ids[0] != expect_first or ids[-1] != expect_last:
            return None
        # verify the scan exactly (box size == count can coincide with a
        # non-box set; cheap vectorized check)
        rel = coords - c_lo
        strides = np.cumprod(np.concatenate([h[1:], [1]])[::-1])[::-1]
        if not np.array_equal(rel @ strides, np.arange(ids.size)):
            return None
        lo[k] = c_lo
        ext[k] = h
    return lo, ext


def _arith_runs(vals: np.ndarray, tile_d: int):
    """Partition sorted anchor values into arithmetic runs whose common
    difference is >= ``tile_d`` — windows within a run then tile disjointly,
    which is all the slice/reshape group extraction needs.  Greedy
    left-to-right; for uniform-pitch anchors this reproduces the classic
    parity grouping (ceil(tile/pitch) runs), and for the near-uniform
    anchors of non-divisible partitions (e.g. 54 dofs / 8 parts: deltas
    7,7,...,6) it adds O(1) extra runs per axis.  Returns a list of
    (anchor-index array, window stride)."""
    runs: list = []  # [ [indices], stride or None ]
    for i, v in enumerate(vals):
        placed = False
        for run in runs:
            idxs, stride = run
            d = int(v - vals[idxs[-1]])
            if stride is None:
                if d >= tile_d:
                    idxs.append(i)
                    run[1] = d
                    placed = True
                    break
            elif d == stride:
                idxs.append(i)
                placed = True
                break
        if not placed:
            runs.append([[i], None])
    return [
        (np.asarray(idxs, np.int64),
         int(stride) if stride is not None else int(tile_d))
        for idxs, stride in runs
    ]


def detect_box_layout(topo, dims, pad_to: int = 8) -> BoxMeta | None:
    """Host: check every subdomain of ``topo`` is an axis-aligned box of the
    ``dims`` dof grid; returns the canvas layout or None (-> general path).
    N-D generalization of structured.detect_rect_layout.

    Anchors need NOT be uniformly pitched (the reference accepts any
    partition, poisson.cc:129-133): per axis, anchors are partitioned into
    arithmetic runs (stride >= tile) and each run cross-product becomes one
    slice/reshape group with its own window stride."""
    import itertools

    dims = tuple(int(d) for d in dims)
    if int(np.prod(dims)) != topo.n_glob or topo.n_sub < 2:
        return None
    boxes = _subdomain_boxes(topo, dims)
    if boxes is None:
        return None
    lo, ext = boxes
    nd = len(dims)
    tile = ext.max(axis=0)
    # anchors: boxes clipped at the low edge sit at the END of their window
    anch = np.where((lo == 0) & (ext < tile[None, :]), lo + ext - tile[None, :], lo)

    vals_per_axis = []
    pitch = np.zeros(nd, np.int64)
    nparts = np.zeros(nd, np.int64)
    for d in range(nd):
        vals = np.unique(anch[:, d])
        nparts[d] = vals.size
        pitch[d] = int(np.diff(vals).min()) if vals.size > 1 else int(tile[d])
        if pitch[d] <= 0:
            return None
        vals_per_axis.append(vals)
    if int(np.prod(nparts)) != topo.n_sub:
        return None
    gidx = np.zeros((topo.n_sub, nd), np.int64)
    for d in range(nd):
        gidx[:, d] = np.searchsorted(vals_per_axis[d], anch[:, d])
        if np.any(vals_per_axis[d][gidx[:, d]] != anch[:, d]):
            return None
    # the subdomain grid must be dense (every tuple exactly once)
    flat = np.ravel_multi_index(gidx.T, nparts)
    if np.unique(flat).size != topo.n_sub:
        return None

    runs_per_axis = [_arith_runs(vals_per_axis[d], int(tile[d]))
                     for d in range(nd)]
    # cap pathological partitions (anchors so irregular that the group
    # count explodes): the canvas is only a win while groups stay few
    if int(np.prod([len(r) for r in runs_per_axis])) > 128:
        return None
    margin = np.maximum(0, -np.array([v[0] for v in vals_per_axis]))

    lut = np.full(tuple(nparts), -1, dtype=np.int64)
    lut[tuple(gidx.T)] = np.arange(topo.n_sub)
    groups = []
    order = []
    padded = np.array(dims) + margin
    for combo in itertools.product(*runs_per_axis):
        rs = [idxs for idxs, _ in combo]
        Gs = tuple(int(s) for _, s in combo)
        ks = lut[np.ix_(*rs)].reshape(-1)
        assert np.all(ks >= 0)
        org = tuple(int(vals_per_axis[d][rs[d][0]]) + int(margin[d])
                    for d in range(nd))
        counts = tuple(int(r.size) for r in rs)
        padded = np.maximum(
            padded, [org[d] + counts[d] * Gs[d] for d in range(nd)]
        )
        groups.append((counts, org, tuple(int(x) for x in ks), Gs))
        order.append(ks)
    order = np.concatenate(order)
    perm = np.argsort(order)
    n_pad = int(-(-int(np.prod(tile)) // pad_to) * pad_to)
    # validity mask (see BoxMeta.starts): needed iff some box is short of
    # the tile while real grid dofs continue past its high edge
    starts_a = np.where(
        (lo == 0) & (ext < tile[None, :]), tile[None, :] - ext, 0
    )
    dims_a = np.array(dims)
    needs_mask = bool(
        np.any((starts_a + ext < tile[None, :]) & (lo + ext < dims_a[None, :]))
    )
    starts_t = (tuple(tuple(int(x) for x in row) for row in starts_a)
                if needs_mask else ())
    exts_t = (tuple(tuple(int(x) for x in row) for row in ext)
              if needs_mask else ())
    return BoxMeta(
        starts=starts_t, exts=exts_t,
        dims=dims, tile=tuple(int(t) for t in tile), n_pad=n_pad,
        margin=tuple(int(m) for m in margin),
        padded=tuple(int(p) for p in padded),
        g=tuple(len(r) for r in runs_per_axis),
        pitch=tuple(int(p) for p in pitch),
        nparts=tuple(int(p) for p in nparts),
        base=tuple(int(v[0]) + int(m) for v, m in
                   zip(vals_per_axis, margin)),
        groups=tuple(groups), perm=tuple(int(x) for x in perm),
    )


def box_local_slots(topo, meta: BoxMeta) -> list[np.ndarray]:
    """Host: canvas slot of each (old-layout) valid dof per subdomain."""
    nd = meta.ndim
    tile = np.array(meta.tile)
    strides = np.cumprod(np.concatenate([tile[1:], [1]])[::-1])[::-1]
    slots = []
    for k in range(topo.n_sub):
        ids = topo.sub2glob[k][topo.valid[k]].astype(np.int64)
        coords = np.stack(np.unravel_index(ids, meta.dims), axis=1)
        c_lo = coords.min(axis=0)
        c_hi = coords.max(axis=0)
        ext = c_hi - c_lo + 1
        anch = np.where((c_lo == 0) & (ext < tile), c_lo + ext - tile, c_lo)
        slots.append(((coords - anch) @ strides).astype(np.int64))
    return slots


def relayout_box(topo, meta: BoxMeta):
    """Host: repack a DDMTopology into the box-canvas layout (the N-D
    analogue of structured.relayout_rect)."""
    from .indexmaps import DDMTopology

    n, n_sub = topo.n_glob, topo.n_sub
    n_pad = meta.n_pad
    slots = box_local_slots(topo, meta)
    sub2glob = np.full((n_sub, n_pad), n, dtype=np.int32)
    valid = np.zeros((n_sub, n_pad), dtype=bool)
    owner = np.zeros((n_sub, n_pad), dtype=bool)
    boundary = np.zeros((n_sub, n_pad), dtype=bool)
    bdist = np.full((n_sub, n_pad), topo.bdist_cap, dtype=np.int32)
    keys, locs = [], []
    for k in range(n_sub):
        v = topo.valid[k]
        s = slots[k]
        ids = topo.sub2glob[k][v]
        sub2glob[k, s] = ids
        valid[k, s] = True
        owner[k, s] = topo.owner[k][v]
        boundary[k, s] = topo.boundary[k][v]
        bdist[k, s] = topo.bdist[k][v]
        keys.append(k * np.int64(n + 1) + ids.astype(np.int64))
        locs.append(s.astype(np.int32))
    keys = np.concatenate(keys)
    locs = np.concatenate(locs)
    order = np.argsort(keys)
    new = DDMTopology(
        n_glob=n, n_sub=n_sub, n_pad=n_pad, overlap=topo.overlap,
        sub2glob=sub2glob, valid=valid, owner=owner, boundary=boundary,
        bdist=bdist, bdist_cap=topo.bdist_cap, dof_owner=topo.dof_owner,
        g2l_keys=keys[order], g2l_locs=locs[order],
        membership=topo.membership, sizes=topo.sizes,
    )
    object.__setattr__(new, "rect", meta)
    return new


# -- device fast paths --------------------------------------------------------


from functools import lru_cache


@lru_cache(maxsize=64)
def _box_valid_mask(meta: BoxMeta):
    """(n_sub, n_pad) bool device constant marking each subdomain's valid
    box within its tile, or None when ``meta`` carries no mask (uniform
    layouts).  Cached per meta (metas are frozen/hashable)."""
    if not meta.starts:
        return None
    nd = meta.ndim
    tsize = int(np.prod(meta.tile))
    coords = np.stack(np.unravel_index(np.arange(tsize), meta.tile), axis=1)
    starts = np.asarray(meta.starts)  # (n_sub, nd)
    exts = np.asarray(meta.exts)
    ok = np.ones((starts.shape[0], tsize), bool)
    for d in range(nd):
        c = coords[None, :, d]
        ok &= (c >= starts[:, d:d + 1]) & (c < starts[:, d:d + 1]
                                           + exts[:, d:d + 1])
    M = np.zeros((starts.shape[0], meta.n_pad), bool)
    M[:, :tsize] = ok
    # numpy, not jnp: this cache outlives any jit trace it is first built
    # under (a cached tracer would leak); numpy operands enter jitted
    # programs as constants
    return M


def box_gather(x: jnp.ndarray, meta: BoxMeta) -> jnp.ndarray:
    """Global (n,) -> (n_sub, n_pad) in canvas layout; pure layout
    transforms + one batch-row permutation (N-D rect_gather)."""
    nd = meta.ndim
    x2 = x.reshape(meta.dims)
    pads = tuple(
        (meta.margin[d], meta.padded[d] - meta.dims[d] - meta.margin[d])
        for d in range(nd)
    )
    xp = jnp.pad(x2, pads)
    tsize = int(np.prod(meta.tile))
    parts = []
    for counts, org, _ks, G in meta.groups:
        starts = org
        limits = tuple(org[d] + counts[d] * G[d] for d in range(nd))
        Wd = lax.slice(xp, starts, limits)
        # (a0*G0, a1*G1, ...) -> (a0, G0, a1, G1, ...) -> (a..., G...)
        inter = []
        for d in range(nd):
            inter += [counts[d], G[d]]
        Wd = Wd.reshape(inter)
        permax = list(range(0, 2 * nd, 2)) + list(range(1, 2 * nd, 2))
        Wd = Wd.transpose(permax)
        # slice each window dim down to the tile
        idx = tuple([slice(None)] * nd
                    + [slice(0, meta.tile[d]) for d in range(nd)])
        T = Wd[idx]
        parts.append(T.reshape(int(np.prod(counts)), tsize))
    X = jnp.concatenate(parts, axis=0)[jnp.asarray(meta.perm)]
    if meta.n_pad > tsize:
        X = jnp.pad(X, ((0, 0), (0, meta.n_pad - tsize)))
    M = _box_valid_mask(meta)
    if M is not None:
        X = X * M
    return X


def box_scatter_add(x_sub: jnp.ndarray, meta: BoxMeta) -> jnp.ndarray:
    """(n_sub, n_pad) canvas-layout -> global (n,) by summation — the exact
    adjoint of :func:`box_gather`."""
    nd = meta.ndim
    tsize = int(np.prod(meta.tile))
    M = _box_valid_mask(meta)
    if M is not None:
        x_sub = x_sub * M
    X = x_sub[:, :tsize]
    acc = jnp.zeros(meta.padded, x_sub.dtype)
    for counts, org, ks, G in meta.groups:
        T = X[jnp.asarray(ks)].reshape(tuple(counts) + tuple(meta.tile))
        pads = tuple([(0, 0)] * nd
                     + [(0, G[d] - meta.tile[d]) for d in range(nd)])
        T = jnp.pad(T, pads)
        # (a..., G...) -> (a0, G0, a1, G1, ...) -> (a0*G0, ...)
        permax = []
        for d in range(nd):
            permax += [d, nd + d]
        T = T.transpose(permax)
        block = T.reshape(tuple(counts[d] * G[d] for d in range(nd)))
        pads = tuple(
            (org[d], meta.padded[d] - org[d] - counts[d] * G[d])
            for d in range(nd)
        )
        acc = acc + jnp.pad(block, pads)
    starts = meta.margin
    limits = tuple(meta.margin[d] + meta.dims[d] for d in range(nd))
    out = lax.slice(acc, starts, limits)
    return out.reshape(-1)


def box_offset_decomp(offsets, meta: BoxMeta):
    """Host: map each global stencil offset (flat, row-major over
    ``meta.dims``) to its per-axis step tuple, or None when any offset does
    not decompose into small grid steps (N-D rect_offset_decomp)."""
    nd = meta.ndim
    strides = np.cumprod(
        np.concatenate([np.array(meta.dims[1:]), [1]])[::-1]
    )[::-1].astype(np.int64)
    out = []
    for d in offsets:
        rem = int(d)
        steps = []
        for ax in range(nd):
            s = int(strides[ax])
            st = int(np.round(rem / s)) if s else 0
            rem2 = rem - st * s
            steps.append(st)
            rem = rem2
        if rem != 0:
            return None
        lim_fast = max(4, meta.tile[-1] // 4)
        # 2|st| < dims[ax] makes the round-to-nearest decomposition the
        # unique small-step representative — without it a true fastest-axis
        # step |s0| > dims[-1]/2 (tiny folded fastest dim) aliases to
        # (s1+1, s0-D0), whose canvas-local offset differs when
        # tile != dims and entries would land at wrong local positions
        ok = abs(steps[-1]) <= lim_fast and all(
            -meta.tile[ax] < steps[ax] < meta.tile[ax]
            and 2 * abs(steps[ax]) < meta.dims[ax]
            for ax in range(nd)
        )
        if not ok:
            return None
        out.append(tuple(steps))
    return out


def box_window_masks(decomp, meta: BoxMeta) -> np.ndarray:
    """Host: (m, n_pad) bool — slot k kept only when the neighbour stays
    inside the canvas tile on every axis."""
    tsize = int(np.prod(meta.tile))
    coords = np.stack(
        np.unravel_index(np.arange(tsize), meta.tile), axis=1
    )  # (tsize, nd)
    masks = np.zeros((len(decomp), meta.n_pad), dtype=bool)
    for k, steps in enumerate(decomp):
        nb = coords + np.array(steps)[None, :]
        ok = np.all((nb >= 0) & (nb < np.array(meta.tile)[None, :]), axis=1)
        masks[k, :tsize] = ok
    return masks


def box_local_offsets(decomp, meta: BoxMeta):
    """Canvas-local flat offset of each per-axis step tuple."""
    tile = np.array(meta.tile)
    strides = np.cumprod(np.concatenate([tile[1:], [1]])[::-1])[::-1]
    return [int(np.array(steps) @ strides) for steps in decomp]
