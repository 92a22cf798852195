"""Galerkin coarse correction: x += R^T (R A R^T)^{-1} R d.

Rebuilds dune/ddm/galerkin_preconditioner.hh:47-363 without its scalability
bottleneck: where the reference round-robins template vectors between
neighbors, computes per-rank dot products, Gathervs the coarse matrix to
rank 0, factorizes there, and funnels every apply through a rank-0
solve + Scatterv (galerkin_preconditioner.hh:151-194 — the author's own TODO
marks this the bottleneck at :217-218), here:

* the coarse matrix is assembled by a scan of batched SpMVs + gathered dots
  (setup, device-wide);
* it is factored once and **replicated** — the coarse solve happens on every
  device redundantly (coarse dim = sum of nev_i, small), eliminating the
  rank-0 serialization entirely (SURVEY.md §2.6 "coarse-level reduction");
* apply = batched restriction dots -> replicated dense solve -> batched
  prolongation scatter.

Coarse-matrix semantics: the reference computes entry ((j,l),(i,k)) as
v_ik^T A^(i) v_jl with rank i's *local* overlapping matrix
(galerkin_preconditioner.hh:279-328).  For basis vectors that vanish on
subdomain boundaries (every POU-finalized space does) this equals the true
global Galerkin product v_ik^T A v_jl, which is what the default
``method="global"`` computes; ``method="local"`` reproduces the reference
formula bit-for-bit (needed for the exact fixture of
tests/test_galerkin_coarse_matrix.cc, whose POU-only vectors do NOT vanish
on the boundary).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ParamTree
from ..core.indexmaps import DDMTopology
from ..core.sparse import SparseELL
from ..coarse.basis import CoarseBasis
from ..solvers.direct import bmv
from ..solvers.direct import factor_batched
from .extract import gather_subdomain, scatter_add_subdomain


def galerkin_coarse_matrix(
    ell: SparseELL, sub2glob: jnp.ndarray, basis: CoarseBasis,
    group: int = 1,
) -> jnp.ndarray:
    """True Galerkin E[(i,k),(j,l)] = v_ik^T A v_jl, (n_c, n_c) dense.

    Scans over *groups* of subdomains j: scatter the group's bases into a
    global multi-RHS block, one SpMV, gather to all subdomains, batched
    dots.  Grouping amortizes the per-step scatter/gather latency
    (16-wide groups cut the step count 16x at the same FLOPs).  Memory
    high-water:
    O(n * nev_max * group)."""
    n = ell.n
    n_sub, nev, n_pad = basis.V.shape
    V = basis.V
    group = max(1, min(group, n_sub))
    while n_sub % group:
        group -= 1
    n_groups = n_sub // group

    if group == 1:
        # compiled scan (one subdomain per step): the per-step state is
        # small, and a compiled loop avoids one dispatch per op
        def body(_, j):
            U = scatter_add_subdomain(V[j].T[None], sub2glob[j][None], n)
            W = ell.mv(U)
            W_sub = gather_subdomain(W, sub2glob)
            return None, jnp.einsum("skp,spl->skl", V, W_sub)

        _, blocks = jax.lax.scan(body, None, jnp.arange(n_sub))
        E = blocks.transpose(1, 2, 0, 3).reshape(n_sub * nev, n_sub * nev)
        return E

    blocks = [
        _galerkin_group_block(
            ell, V, sub2glob,
            V[g * group : (g + 1) * group],
            sub2glob[g * group : (g + 1) * group],
        )
        for g in range(n_groups)
    ]
    blocks = jnp.stack(blocks)  # (n_groups, i, k, group*nev)
    E = blocks.transpose(1, 2, 0, 3).reshape(n_sub * nev, n_sub * nev)
    return E


def _galerkin_group_block(ell, V, sub2glob, Vg, s2g_g):
    """One group's coarse-matrix column block.

    Scatters each group member's basis into its own global column block
    (vmapped 1-D scatters), one multi-RHS SpMV, gather, batched dots.
    Runs EAGERLY and is looped from Python: both lax.scan around the group
    loop and jit of this body exhausted compiler memory at scale on the
    first accelerator this code ran on (the fused scatter lowered poorly);
    the eager ops are individually cheap."""
    n = ell.n
    group, nev, n_pad = Vg.shape
    Ug = jax.vmap(
        lambda vj, sj: scatter_add_subdomain(vj.T[None], sj[None], n)
    )(Vg, s2g_g)  # (group, n, nev)
    U = Ug.transpose(1, 0, 2).reshape(n, group * nev)
    W = ell.mv(U)  # (n, group*nev)
    W_sub = gather_subdomain(W, sub2glob)  # (n_sub, n_pad, group*nev)
    return jnp.einsum("skp,spl->skl", V, W_sub)  # (n_sub, nev, group*nev)


@partial(jax.jit, static_argnames=("n_sub", "nev"))
def _pairs_device(A_sub, V, pi, pj, m_pair, *, n_sub, nev):
    """Device half of :func:`galerkin_coarse_matrix_pairs` — a single jitted
    executable (module-level: the eager formulation pays one-op
    compile/dispatch warmup per build; one fused executable compiles once
    and persists in the compile cache)."""
    # W[i] = A^(i) V_i^T : (n_sub, n_pad, nev) — as per-vector
    # multiply+reduce, not a narrow dot_general (see solvers/direct.py:bmv;
    # not yet timed against einsum on the GPU).  Under sharded setup this (the
    # expensive step) partitions over the subdomain axis; the pair-indexed
    # assembly below runs on GSPMD-inferred shardings (the pair gather
    # moves only W and V, ~MBs)
    W = jnp.stack(
        [jnp.sum(A_sub * V[:, k, None, :], axis=2) for k in range(nev)],
        axis=2,
    )
    # gather v_jl onto i's local numbering: (n_pairs, nev, n_pad).  As a
    # FLAT 1-D gather through maybe_tiled_take (this general path serves
    # unstructured topologies; structured ones take the shift-grouped fast
    # path below)
    from ..core.sparse import maybe_tiled_take

    Vpad = jnp.concatenate([V, jnp.zeros((n_sub, nev, 1), V.dtype)], axis=2)
    w = Vpad.shape[2]
    flat_idx = ((pj[:, None, None] * nev
                 + jnp.arange(nev)[None, :, None]) * w
                + m_pair[:, None, :])
    Vj_on_i = maybe_tiled_take(Vpad.reshape(-1), flat_idx)
    # blocks: E_pair[x, k, l] = sum_p (A^(i) v_ik)[p] * v_jl[p]
    #                         = v_jl^T A v_ik  ->  E[(j,l), (i,k)]
    E_pair = jnp.einsum("xpk,xlp->xkl", W[pi], Vj_on_i)
    # assemble into (n_c, n_c); pair blocks are disjoint -> add == set
    nc = n_sub * nev
    rows_idx = pj[:, None, None] * nev + jnp.arange(nev)[None, None, :]
    cols_idx = pi[:, None, None] * nev + jnp.arange(nev)[None, :, None]
    shp = (pi.shape[0], nev, nev)
    E = jnp.zeros((nc, nc), V.dtype)
    return E.at[
        jnp.broadcast_to(rows_idx, shp).reshape(-1),
        jnp.broadcast_to(cols_idx, shp).reshape(-1),
    ].add(E_pair.reshape(-1))


def _pairs_maps(topo):
    """(pi, pj, m_pair) overlapping-pair index maps, cached on the topology."""
    cached = getattr(topo, "_pairs_maps", None)
    if cached is not None:
        return cached
    # overlapping pairs from the membership graph
    # (int32: intersection sizes overflow int8 — a 16x16 overlap region is
    # exactly 256 dofs and wrapped the self-pair count to zero)
    M = topo.membership.astype(np.int32)
    inter = (M @ M.T).tocoo()
    pi = inter.row.astype(np.int32)
    pj = inter.col.astype(np.int32)
    # j-local index of subdomain i's p-th dof (n_pairs, n_pad), n_pad = absent
    rows = np.minimum(topo.sub2glob[pi], topo.n_glob)  # (n_pairs, n_pad)
    m_pair = topo.lookup(pj[:, None], rows)
    m_pair = np.where((m_pair < 0) | ~topo.valid[pi], topo.n_pad, m_pair)
    maps = (jnp.asarray(pi), jnp.asarray(pj),
            jnp.asarray(m_pair.astype(np.int32)))
    object.__setattr__(topo, "_pairs_maps", maps)
    return maps


def _pairs_shift_maps(topo):
    """Host: group overlapping pairs by the CONSTANT local-index shift of
    the rect canvas (cached on the topology).

    For same-width row-major rect subdomains, j's local index of i's local
    dof p is simply ``p + d`` with d = (r0_i - r0_j) * w + (c0_i - c0_j) —
    so the pair gather (a general 14M-element gather at the flagship)
    becomes a handful of row-gathers + static shifted slices.  Pairs with differing rect widths (grid-boundary subdomains)
    fall back to the general gather.

    Returns (shifts, sgroups, gen_idx): static shift values, matching pair
    index arrays, and the general-path remainder.
    """
    cached = getattr(topo, "_pairs_shift_cache", None)
    if cached is not None:
        return cached
    pi_j, pj_j, _ = _pairs_maps(topo)
    pi, pj = np.asarray(pi_j), np.asarray(pj_j)
    # uniform canvas tile: padded SLOT index is canvas-row-major
    # (slot = (coord - anchor) @ tile_strides) for every subdomain,
    # including clipped boundary boxes — dims/tile are the common canvas
    # protocol of RectMeta (2-D) and boxnd.BoxMeta (N-D)
    dims = topo.rect.dims
    tile = np.array(topo.rect.tile, np.int64)
    strides = np.cumprod(np.concatenate([tile[1:], [1]])[::-1])[::-1]
    nd = len(dims)
    n_sub = topo.n_sub
    A0 = np.zeros((n_sub, nd), np.int64)
    canvas = np.zeros(n_sub, bool)
    for k in range(n_sub):
        slots = np.flatnonzero(topo.valid[k])
        ids = topo.sub2glob[k][slots].astype(np.int64)
        coords = np.stack(np.unravel_index(ids, dims), axis=1)
        lc = np.stack(np.unravel_index(slots, tuple(tile)), axis=1)
        A0[k] = coords[0] - lc[0]
        # verify the canvas layout for every valid slot (vector-valued or
        # reordered numberings fail here and take the general gather)
        canvas[k] = np.array_equal(coords, A0[k][None, :] + lc)
    same = canvas[pi] & canvas[pj]
    d_all = (A0[pi] - A0[pj]) @ strides
    shifts, sgroups = [], []
    for d in np.unique(d_all[same]):
        idx = np.flatnonzero(same & (d_all == d))
        shifts.append(int(d))
        sgroups.append(jnp.asarray(idx.astype(np.int32)))
    gen_idx = jnp.asarray(np.flatnonzero(~same).astype(np.int32))
    maps = (tuple(shifts), tuple(sgroups), gen_idx)
    object.__setattr__(topo, "_pairs_shift_cache", maps)
    return maps


@partial(jax.jit, static_argnames=("n_sub", "nev", "shifts"))
def _pairs_device_shift(A_sub, V, pi, pj, m_pair, sgroups, gen_idx,
                        *, n_sub, nev, shifts):
    """Rect-canvas variant of :func:`_pairs_device`: the pair gather runs as
    per-shift row-gathers + static shifted slices (bandwidth-class) instead
    of one general element-at-a-time gather; validity is enforced by the
    exact ``m_pair == p + d`` mask (dofs outside S_j keep the dump value
    n_pad there, so row-wrap aliases of the linear shift formula never
    contribute).  The flagship has 9 shift groups and no general
    remainder; the result is bitwise equal to the general path."""
    n_pad = V.shape[2]
    W = jnp.stack(
        [jnp.sum(A_sub * V[:, k, None, :], axis=2) for k in range(nev)],
        axis=2,
    )
    ar = jnp.arange(n_pad, dtype=m_pair.dtype)
    E_pair = jnp.zeros((pi.shape[0], nev, nev), V.dtype)
    for d, idx in zip(shifts, sgroups):
        Vg = V[pj[idx]]  # (n_g, nev, n_pad) leading-axis row gather
        if d >= 0:
            Vs = jnp.pad(Vg, ((0, 0), (0, 0), (0, d)))[:, :, d:]
        else:
            Vs = jnp.pad(Vg, ((0, 0), (0, 0), (-d, 0)))[:, :, :n_pad]
        mask = m_pair[idx] == ar[None, :] + d
        Vs = Vs * mask[:, None, :]
        Ep = jnp.einsum("xpk,xlp->xkl", W[pi[idx]], Vs)
        E_pair = E_pair.at[idx].set(Ep)
    if gen_idx.shape[0]:
        Vpad = jnp.concatenate(
            [V, jnp.zeros((n_sub, nev, 1), V.dtype)], axis=2
        )
        Vj = Vpad[
            pj[gen_idx][:, None, None],
            jnp.arange(nev)[None, :, None],
            m_pair[gen_idx][:, None, :],
        ]
        Ep = jnp.einsum("xpk,xlp->xkl", W[pi[gen_idx]], Vj)
        E_pair = E_pair.at[gen_idx].set(Ep)
    nc = n_sub * nev
    rows_idx = pj[:, None, None] * nev + jnp.arange(nev)[None, None, :]
    cols_idx = pi[:, None, None] * nev + jnp.arange(nev)[None, :, None]
    shp = (pi.shape[0], nev, nev)
    E = jnp.zeros((nc, nc), V.dtype)
    return E.at[
        jnp.broadcast_to(rows_idx, shp).reshape(-1),
        jnp.broadcast_to(cols_idx, shp).reshape(-1),
    ].add(E_pair.reshape(-1))


def galerkin_coarse_matrix_pairs(
    A_sub: jnp.ndarray,
    topo,
    basis: CoarseBasis,
) -> jnp.ndarray:
    """Pairwise-local coarse matrix — the batched formulation of the reference's
    neighbor-pair dot products (galerkin_preconditioner.hh:279-328):

        E[(i,k),(j,l)] = v_ik^T A^(i) v_jl

    over the overlapping subdomain pairs (i, j) only, with A^(i) the dense
    extracted subdomain matrix.  EXACT equal to the true Galerkin product
    v_ik^T A v_jl whenever the basis vanishes on subdomain boundaries (every
    POU-finalized coarse space does — same argument as the reference's):
    the couplings extraction drops, (p in S_i, q outside S_i), only touch
    rows p on the graph boundary of S_i where v_ik = 0.

    Replaces the n_sub-step scan of global SpMVs with ONE batched narrow
    matmul + one pair-batched gather/einsum.
    """
    n_sub, nev, _ = basis.V.shape
    pi, pj, m_pair = _pairs_maps(topo)
    if getattr(topo, "rect", None) is not None:
        shifts, sgroups, gen_idx = _pairs_shift_maps(topo)
        return _pairs_device_shift(
            A_sub, basis.V, pi, pj, m_pair, sgroups, gen_idx,
            n_sub=n_sub, nev=nev, shifts=shifts,
        )
    return _pairs_device(A_sub, basis.V, pi, pj, m_pair,
                         n_sub=n_sub, nev=nev)


def galerkin_coarse_matrix_local(
    A_sub: jnp.ndarray,
    sub2glob: jnp.ndarray,
    basis: CoarseBasis,
    n_glob: int,
) -> jnp.ndarray:
    """Reference-formula coarse matrix: E[(j,l),(i,k)] = v_ik^T A^(i) v_jl
    with A^(i) the dense overlapping subdomain matrix
    (galerkin_preconditioner.hh:279-328 semantics)."""
    n_sub, nev, n_pad = basis.V.shape
    V = basis.V

    def body(_, j):
        U = scatter_add_subdomain(V[j].T[None], sub2glob[j][None], n_glob)
        U_sub = gather_subdomain(U, sub2glob)  # (n_sub, n_pad, nev) = v_jl on S_i
        W = jnp.einsum("spq,sql->spl", A_sub, U_sub)  # A^(i) v_jl
        blk = jnp.einsum("skp,spl->slk", V, W)  # rows (j,l), cols (i,k)
        return None, blk

    _, blocks = jax.lax.scan(body, None, jnp.arange(n_sub))
    # blocks: (j, i, l, k) -> E[(j,l),(i,k)]
    E = blocks.transpose(0, 2, 1, 3).reshape(n_sub * nev, n_sub * nev)
    return E


def _mask_inactive(E: jnp.ndarray, active: jnp.ndarray) -> jnp.ndarray:
    """Decouple inactive (padding) coarse dofs: zero rows/cols, unit diag.
    The reference instead gathers exactly sum(nev_i) vectors
    (num_t_per_rank, galerkin_preconditioner.hh:248-256); fixed shapes force
    padding here, and unit diagonal slots make the padded coarse matrix
    equivalent."""
    from ..core.mesh import replicate

    a = replicate(active).reshape(-1)
    E = jnp.where(a[:, None] & a[None, :], E, 0.0)
    return E + jnp.diag(jnp.where(a, 0.0, 1.0))


@jax.tree_util.register_dataclass
@dataclass
class GalerkinPreconditioner:
    sub2glob: jnp.ndarray  # (n_sub, n_pad)
    V: jnp.ndarray  # (n_sub, nev_max, n_pad)
    active: jnp.ndarray  # (n_sub, nev_max)
    coarse: object  # factorization with .solve((1, n_c) or (1, n_c, k))
    axis: str | None = field(default=None, metadata=dict(static=True))
    # (K, n) gather-dual of the scatter; the sharded apply embeds its local
    # slab into a zero full batch first (extract.py:scatter_add_subdomain_shard)
    dualT: jnp.ndarray | None = None
    # structured-rect canvas layout (core/structured.py): bandwidth
    # gather/scatter; kept under shard_map via the *_shard variants
    rect: object | None = field(default=None, metadata=dict(static=True))
    # full subdomain count (see SchwarzPreconditioner.n_sub_full)
    n_sub_full: int = field(default=0, metadata=dict(static=True))
    # coarse matrix kept for iterative refinement of the coarse solve:
    # ring-type coarse bases can make E near-singular (measured cond ~6.5e9
    # at islands 384^2/256), where this backend's double-single f64 direct
    # solve loses ~eps_ds*cond ~ 2e-5 — enough to stall GMRES at ~1e-7.
    # Each refinement step contracts the solve error by that same factor at
    # the cost of one (nc, nc) multiply+reduce matvec (~33 MB read).
    E_mat: jnp.ndarray | None = None
    refine: int = field(default=0, metadata=dict(static=True))

    def _coarse_solve(self, rhs_flat: jnp.ndarray) -> jnp.ndarray:
        y = self.coarse.solve(rhs_flat.reshape(1, -1))[0]
        if self.E_mat is not None:
            for _ in range(self.refine):
                r = rhs_flat - jnp.sum(self.E_mat * y[None, :], axis=1)
                y = y + self.coarse.solve(r.reshape(1, -1))[0]
        return y

    def apply(self, d: jnp.ndarray) -> jnp.ndarray:
        from ..core.structured import (
            rect_gather,
            rect_gather_shard,
            rect_scatter_add,
            rect_scatter_add_shard,
        )
        from .extract import scatter_add_subdomain_shard

        n = d.shape[0]
        n_sub, nev, _ = self.V.shape
        if self.rect is not None:
            if self.axis is None:
                d_sub = rect_gather(d, self.rect)
            else:
                d_sub = rect_gather_shard(d, self.rect, self.axis, n_sub)
        else:
            d_sub = gather_subdomain(d, self.sub2glob)
        # restriction: single-defect contraction as multiply+reduce (bmv)
        alpha = bmv(self.V, d_sub)
        if self.axis is not None:
            # subdomain-sharded execution: collect the full coarse defect,
            # solve replicated, keep the local block
            alpha_full = jax.lax.all_gather(alpha, self.axis, tiled=True)
            beta_full = self._coarse_solve(alpha_full.reshape(-1))
            shard = jax.lax.axis_index(self.axis)
            beta = jax.lax.dynamic_slice_in_dim(
                beta_full.reshape(-1, nev), shard * n_sub, n_sub, axis=0
            )
        else:
            beta = self._coarse_solve(alpha.reshape(-1)).reshape(n_sub, nev)
        x_sub = (self.V * beta[:, :, None]).sum(axis=1)  # prolongation
        if self.rect is not None:
            if self.axis is None:
                return rect_scatter_add(x_sub, self.rect)
            return rect_scatter_add_shard(x_sub, self.rect, self.axis)
        if self.axis is not None:
            if self.dualT is not None and self.n_sub_full:
                return scatter_add_subdomain_shard(
                    x_sub, self.dualT, self.axis, self.n_sub_full
                )
            return jax.lax.psum(
                scatter_add_subdomain(x_sub, self.sub2glob, n), self.axis
            )
        return scatter_add_subdomain(x_sub, self.sub2glob, n, dualT=self.dualT)


def build_galerkin(
    ell: SparseELL,
    topo: DDMTopology,
    basis: CoarseBasis,
    ptree: ParamTree | None = None,
    subtree_name: str = "coarse_solver",
    method: str = "global",
    A_sub: jnp.ndarray | None = None,
) -> GalerkinPreconditioner:
    ptree = ptree or ParamTree({subtree_name: {"type": "lu"}})
    sub = ptree.sub(subtree_name)
    if "type" not in sub:
        raise KeyError(
            f"You must specify the solver in the subtree {subtree_name} "
            "using the key 'type'"
        )
    solver_type = sub.get("type")
    from ..core.mesh import batched
    from ..obs.logger import scoped

    s2g = batched(topo.sub2glob)
    with scoped("GalerkinPrec", "build Matrix"):
        if method == "pairs":
            # production fast path (see galerkin_coarse_matrix_pairs):
            # exact for POU-finalized bases
            if A_sub is None:
                from ..core.indexmaps import extraction_map
                from .extract import extract_subdomain_dense

                lc = extraction_map(topo, np.asarray(ell.colsT).T)
                A_sub = extract_subdomain_dense(
                    ell, s2g, batched(topo.valid), batched(lc),
                    rect=getattr(topo, "rect", None),
                )
            E = galerkin_coarse_matrix_pairs(A_sub, topo, basis)
        elif method == "global":
            # scan-of-SpMVs formulation: replicated compute under sharded
            # setup (fallback path; the production path is 'pairs')
            from ..core.mesh import replicate
            import dataclasses as _dc

            E = galerkin_coarse_matrix(
                ell, replicate(s2g),
                _dc.replace(basis, V=replicate(basis.V)),
            )
        elif method == "local":
            if A_sub is None:
                raise ValueError("method='local' requires the dense A_sub batch")
            from ..core.mesh import replicate
            import dataclasses as _dc

            E = galerkin_coarse_matrix_local(
                replicate(A_sub), replicate(s2g),
                _dc.replace(basis, V=replicate(basis.V)), topo.n_glob,
            )
        else:
            raise ValueError(f"unknown coarse-matrix method '{method}'")
        E = _mask_inactive(E, basis.active)
        jax.block_until_ready(E)
    with scoped("GalerkinPrec", "factor A0"):
        # Opt-in f32-seeded Newton-Schulz inverse for the coarse factor
        # (solvers/direct.py:newton_inverse_batched), mirroring the fine
        # level's schwarz.subdomain_solver.newton_rtol: the (1, nc, nc)
        # f64 Cholesky + triangular solve are sequential recurrences while
        # the Newton path is matmul-only.  Same safety
        # story as the fine knob — Newton error is multiplicative
        # (X = E^{-1}(I+R)), residual-controlled with an exact-f64
        # Cholesky fallback — and the coarse apply's iterative refinement
        # (refine below, stored E) contracts any accepted residual
        # further.  Off unless coarse_solver.newton_rtol is set.
        nrtol = sub.get("newton_rtol", None)
        from ..solvers.direct import resolve_solver_type

        # mirrors the fine level's construction gate
        # (precond/schwarz.py): default 'direct' on the CPU backend,
        # 'newton' on an accelerator (both routes' GPU times are in
        # PERF.md); a CPU test can force the branch with
        # coarse_solver.construction = newton
        construction = sub.get(
            "construction",
            "direct" if jax.default_backend() == "cpu" else "newton",
        )
        use_newton = (nrtol is not None
                      and resolve_solver_type(solver_type) == "cholesky"
                      and construction == "newton")
        if use_newton:
            # a cholesky-declared coarse matrix must have a strictly
            # positive finite diagonal; clamping instead (the previous
            # jnp.maximum(diag, 1e-300)) would turn an indefinite/overflowed
            # E into ~1e150 scale factors and poison even the exact-f64
            # fallback inside newton_inverse_batched
            diag_h = np.asarray(jnp.diagonal(E))
            if not (np.isfinite(diag_h).all() and (diag_h > 0).all()):
                use_newton = False
        if use_newton:
            from ..solvers.direct import BatchedInverse, newton_inverse_batched

            # symmetric Jacobi equilibration (two cheap rank-1 scalings):
            # the f32 Cholesky seed carries eps32*cond error, and scaling
            # removes the coefficient-contrast dynamic range from E the
            # same way api.setup_problem does for the fine operator
            dE = jnp.sqrt(jnp.diagonal(E))
            Es = E / (dE[:, None] * dE[None, :])
            c0 = newton_inverse_batched(Es[None], rtol=float(nrtol))
            # store_dtype=None always packs a BatchedInverse
            assert isinstance(c0, BatchedInverse), type(c0)
            inv = c0.inv[0] / (dE[:, None] * dE[None, :])
            # the exact cholesky path forms L^{-T}L^{-1}, exactly symmetric
            # for CG; the Newton iterate is symmetric only to roundoff —
            # symmetrize once at setup (negligible at (nc, nc))
            inv = 0.5 * (inv + inv.T)
            coarse = BatchedInverse(inv=inv[None])
        else:
            coarse = factor_batched(E[None], solver_type)
        if sub.get("precision", "f64") == "dd":
            # double-single coarse apply (solvers/direct.py:dd_matvec) — the
            # replicated coarse solve is a dense matvec per apply; dd runs
            # it as f32 products
            from ..solvers.direct import BatchedInverse, BatchedInverseDD, dd_split

            if isinstance(coarse, BatchedInverse):
                h, l = dd_split(coarse.inv)
                coarse = BatchedInverseDD(inv_hi=h, inv_lo=l)
        jax.block_until_ready(coarse)
    from ..core.indexmaps import dual_scatter_map

    # refinement default 2: two steps bring the coarse solve to true-f64
    # accuracy even at cond(E) ~ 1e10 (contraction eps_ds*cond per step) for
    # two negligible (nc, nc) matvecs per apply; refine=0 disables and drops
    # the stored E
    refine = int(sub.get("refine", 2))
    return GalerkinPreconditioner(
        sub2glob=s2g, V=basis.V, active=basis.active, coarse=coarse,
        dualT=jnp.asarray(dual_scatter_map(topo)),
        rect=getattr(topo, "rect", None),
        E_mat=E if refine > 0 else None, refine=refine,
        n_sub_full=topo.n_sub,
    )
