"""Per-subdomain Neumann matrix assembly.

Rebuilds the reference's Neumann-matrix machinery — the AssembleWrapper
correction capture (examples/assemblewrapper.hh:27-490) plus the
correction-triple MPI exchange and assembly in
``assemble_overlapping_matrices`` (examples/pdelab_helper.hh:113-436) — from
the global viewpoint the batched build affords:

The reference subtracts, from the overlapping Dirichlet matrix, per-element
contributions of elements that cross a subdomain's boundary (shipped as
triples from the ranks that own those elements).  The net result is the
subdomain **Neumann matrix**

    A_neu^(i) = sum of element matrices over elements fully inside S_i

and, for NeumannRegion::Overlap, the Neumann matrix of the overlap region
(elements whose dofs all have boundary distance <= 2*overlap).  Since the
whole mesh is resident here, we assemble those element sums directly: a
host-precomputed padded (subdomain -> element list, local dof map) and one
batched scatter-add of the global element-matrix batch into dense
(n_sub, n_pad, n_pad) blocks.  No correction exchange exists at all.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.indexmaps import DDMTopology


def subdomain_stamp_lists(
    dofs: np.ndarray,
    topo: DDMTopology,
    dof_mask: np.ndarray | None = None,
):
    """Host: per subdomain, the assembly *stamps* fully inside its (masked)
    dof set.

    A stamp is one atomic assembly contribution — a CG element matrix, a DG
    volume block, or a DG face block — given by its global dof tuple
    ``dofs[s] (nl,)``.  This generalizes the reference's element-level
    Neumann-correction bookkeeping (assemblewrapper.hh volume *and* skeleton
    paths) to any discretization.

    dof_mask: optional (n_sub, n_pad) bool restricting the region (e.g.
    bdist <= 2*overlap for the overlap-region Neumann matrix B_neu).
    Returns (sub_elems (n_sub, max_e) int64 padded with n_stamps,
             sub_locs (n_sub, max_e, nl) int32 padded with n_pad).
    """
    import scipy.sparse as sps

    n_e, nl = dofs.shape
    n_sub, n_pad = topo.sub2glob.shape
    n = topo.n_glob

    # inside(k, e) <=> every dof of stamp e lies in (the masked) subdomain k.
    # Computed as one sparse matmul instead of a Python loop of (n_e, nl)
    # fancy indexes over the subdomains.
    if dof_mask is None:
        M = (topo.membership > 0).astype(np.int32).tocsr()
    else:
        mk, ml = np.nonzero(np.asarray(dof_mask, bool) & topo.valid)
        cols = topo.sub2glob[mk, ml].astype(np.int64)
        M = sps.csr_matrix(
            (np.ones(mk.size, np.int32), (mk, cols)), shape=(n_sub, n)
        )
    inc = sps.csr_matrix(
        (
            np.ones(n_e * nl, np.int32),
            (dofs.reshape(-1).astype(np.int64), np.repeat(np.arange(n_e), nl)),
        ),
        shape=(n, n_e),
    )
    C = (M @ inc).tocsr()
    C.data[C.data != nl] = 0
    C.eliminate_zeros()
    sub_of, elem_of = C.nonzero()  # row-major: grouped by subdomain
    counts = np.diff(C.indptr)
    max_e = max(int(counts.max()) if counts.size else 1, 1)

    sub_elems = np.full((n_sub, max_e), n_e, dtype=np.int64)
    sub_locs = np.full((n_sub, max_e, nl), n_pad, dtype=np.int32)
    pos = np.arange(sub_of.size) - np.repeat(C.indptr[:-1], counts)
    sub_elems[sub_of, pos] = elem_of
    sub_locs[sub_of, pos] = topo.lookup(sub_of[:, None], dofs[elem_of])
    return sub_elems, sub_locs


def crossing_stamp_lists(
    dofs: np.ndarray,
    topo: DDMTopology,
    dof_mask: np.ndarray | None = None,
):
    """Host: per subdomain, the stamps PARTIALLY inside its (masked) dof set
    — the Neumann *correction* stamps.

    This is the subtraction form of the reference's AssembleWrapper capture
    (examples/assemblewrapper.hh:27-490): instead of summing the elements
    fully inside the region, sum A_glob restricted to the region and
    subtract the contributions of elements that cross its boundary.  At
    bench scale crossing stamps are ~a perimeter (≈1/7 of the full count),
    so the dense scatter-add shrinks by the same factor.

    Returns (sub_elems, sub_locs) exactly like
    :func:`subdomain_stamp_lists`, except stamps have 1..nl-1 dof
    occurrences inside, and dof slots OUTSIDE the (masked) set map to the
    dump slot ``n_pad`` so their contributions fall off the dense canvas.
    """
    import scipy.sparse as sps

    n_e, nl = dofs.shape
    n_sub, n_pad = topo.sub2glob.shape
    n = topo.n_glob

    inset_keys = None  # None -> in-set == in-subdomain (lookup >= 0)
    if dof_mask is None:
        M = (topo.membership > 0).astype(np.int32).tocsr()
    else:
        mk, ml = np.nonzero(np.asarray(dof_mask, bool) & topo.valid)
        cols = topo.sub2glob[mk, ml].astype(np.int64)
        # sorted (k, dof) key set — O(nnz) instead of a dense (n_sub, n)
        # bool map (which is 38 MB at bench and ~15 GB at the scale ceiling)
        inset_keys = np.sort(mk.astype(np.int64) * (n + 1) + cols)
        M = sps.csr_matrix(
            (np.ones(mk.size, np.int32), (mk, cols)), shape=(n_sub, n)
        )
    inc = sps.csr_matrix(
        (
            np.ones(n_e * nl, np.int32),
            (dofs.reshape(-1).astype(np.int64), np.repeat(np.arange(n_e), nl)),
        ),
        shape=(n, n_e),
    )
    C = (M @ inc).tocsr()
    C.data[C.data == nl] = 0  # drop fully-inside stamps; partial ones stay
    C.eliminate_zeros()
    sub_of, elem_of = C.nonzero()
    counts = np.diff(C.indptr)
    max_e = max(int(counts.max()) if counts.size else 1, 1)

    sub_elems = np.full((n_sub, max_e), n_e, dtype=np.int64)
    sub_locs = np.full((n_sub, max_e, nl), n_pad, dtype=np.int32)
    pos = np.arange(sub_of.size) - np.repeat(C.indptr[:-1], counts)
    sub_elems[sub_of, pos] = elem_of
    locs = topo.lookup(sub_of[:, None], dofs[elem_of])
    if inset_keys is None:
        locs = np.where(locs < 0, n_pad, locs)
    else:
        key = sub_of[:, None].astype(np.int64) * (n + 1) + dofs[elem_of]
        p = np.searchsorted(inset_keys, key)
        p = np.minimum(p, max(inset_keys.size - 1, 0))
        ok = (inset_keys[p] == key) & (locs >= 0)
        locs = np.where(ok, locs, n_pad)
    sub_locs[sub_of, pos] = locs.astype(np.int32)
    return sub_elems, sub_locs


def subdomain_element_lists(
    elems: np.ndarray,
    topo: DDMTopology,
    n_comp: int = 1,
    dof_mask: np.ndarray | None = None,
):
    """Element-based convenience wrapper around subdomain_stamp_lists."""
    n_e, nd = elems.shape
    if n_comp == 1:
        dofs = elems
    else:
        dofs = (elems[:, :, None] * n_comp + np.arange(n_comp)).reshape(n_e, -1)
    return subdomain_stamp_lists(dofs, topo, dof_mask=dof_mask)


def neumann_dense(
    Ke: jnp.ndarray,
    sub_elems: jnp.ndarray,
    sub_locs: jnp.ndarray,
    n_pad: int,
) -> jnp.ndarray:
    """Device: batched dense Neumann matrices (n_sub, n_pad, n_pad).

    Ke: (n_e, nl, nl) global element matrices; padding elements (index n_e)
    gather a zero block.
    """
    from ..core.mesh import batched

    n_e, nl, _ = Ke.shape
    n_sub, max_e = sub_elems.shape
    Kp = jnp.concatenate([Ke, jnp.zeros((1, nl, nl), Ke.dtype)])
    Ks = Kp[sub_elems]  # (n_sub, max_e, nl, nl)
    A = batched(jnp.zeros((n_sub, n_pad + 1, n_pad + 1), Ke.dtype))
    s_idx = jnp.arange(n_sub)[:, None, None, None]
    r_idx = sub_locs[:, :, :, None]
    c_idx = sub_locs[:, :, None, :]
    A = A.at[s_idx, r_idx, c_idx].add(Ks)
    return A[:, :n_pad, :n_pad]


def eliminate_dirichlet_dense(
    A: jnp.ndarray, dmask_sub: jnp.ndarray, unit_diag_padding: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Symmetric Dirichlet elimination on a dense subdomain batch
    (pdelab_helper.hh:33-46 semantics: Dirichlet rows/cols -> identity).

    dmask_sub: (n_sub, n_pad) bool.  unit_diag_padding: optional (n_sub,
    n_pad) bool mask of slots that additionally get a unit diagonal (padding
    slots, so factorizations are well-posed).

    On concrete arrays this dispatches through a DONATED jit — the batch is
    rewritten in place instead of materializing a second copy (4.1 GB at
    3-D bench scale, where the eager where+add OOMed with A_neu and B_neu
    both live on a 16 GB device).
    """
    import jax

    if not isinstance(A, jax.core.Tracer) and jax.default_backend() != "cpu":
        if unit_diag_padding is None:
            return _elim_jit2()(A, dmask_sub)
        return _elim_jit3()(A, dmask_sub, unit_diag_padding)
    return _elim_impl(A, dmask_sub, unit_diag_padding)


def _elim_impl(A, dmask_sub, unit_diag_padding):
    d = dmask_sub.astype(bool)
    keep = ~(d[:, :, None] | d[:, None, :])
    A = jnp.where(keep, A, 0.0)
    p = A.shape[-1]
    eye = jnp.eye(p, dtype=A.dtype)
    diag_one = d
    if unit_diag_padding is not None:
        diag_one = diag_one | unit_diag_padding
    A = A + eye[None] * diag_one[:, :, None].astype(A.dtype)
    return A


def _elim_jit2():
    import jax

    global _ELIM2
    if "_ELIM2" not in globals():
        _ELIM2 = jax.jit(
            lambda A, d: _elim_impl(A, d, None), donate_argnums=0
        )
    return _ELIM2


def _elim_jit3():
    import jax

    global _ELIM3
    if "_ELIM3" not in globals():
        _ELIM3 = jax.jit(_elim_impl, donate_argnums=0)
    return _ELIM3


def scale_matrix_with_pou(
    C: jnp.ndarray, pou: jnp.ndarray, donate: bool = False
) -> jnp.ndarray:
    """C[i][j] *= pou[i]*pou[j] (reference: detail::scale_matrix_with_pou,
    coarse_spaces.hh:74-96) — dense batched version.

    donate=True rewrites C in place through a donated jit (the caller must
    not reuse C): the eager form holds input + intermediate + output — 3
    batch-sized arrays, 12.3 GB at 3-D bench scale."""
    import jax

    if donate and not isinstance(C, jax.core.Tracer) \
            and jax.default_backend() != "cpu":
        global _POU_SCALE_JIT
        if "_POU_SCALE_JIT" not in globals():
            _POU_SCALE_JIT = jax.jit(
                lambda c, w: c * w[:, :, None] * w[:, None, :],
                donate_argnums=0,
            )
        return _POU_SCALE_JIT(C, pou)
    return C * pou[:, :, None] * pou[:, None, :]
