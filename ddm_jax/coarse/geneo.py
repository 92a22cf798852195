"""GenEO coarse space (Generalized Eigenproblems in the Overlaps).

Rebuilds GenEOCoarseSpace (dune/ddm/coarsespaces/coarse_spaces.hh:268-333):
per subdomain, solve

    A_neu v = lambda (D B_neu D) v

with A_neu the subdomain Neumann matrix, B_neu the overlap-region Neumann
matrix, and D the partition of unity (scale_matrix_with_pou,
coarse_spaces.hh:74-96), then POU-scale + normalize the kept eigenvectors
(finalize_eigenvectors, coarse_spaces.hh:52-61).

Also provides the **algebraic** GenEO variant following Al Daas, Jolivet,
Rees (doi 10.1137/22M1469833; reference: detail::build_algebraic_neumann,
coarse_spaces.hh:98-206 and the #if 0 AlgebraicGenEOCoarseSpace at
:335-392): the Neumann matrix is approximated from matrix data alone by
subtracting |off-subdomain| row sums from boundary diagonals — no element
re-assembly needed.

Batched shape: all subdomain eigenproblems solve as ONE batched dense GEVP
(eigen/dense_gevp.py); the reference's per-rank sequential Lanczos with
retries disappears.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ParamTree
from ..core.mesh import batched
from ..eigen.params import EigensolverParams
from ..fem.subassembly import (
    eliminate_dirichlet_dense,
    neumann_dense,
    scale_matrix_with_pou,
    subdomain_stamp_lists,
)
from ..precond.extract import gather_subdomain
from .basis import CoarseBasis, finalize_basis


def neumann_matrices(p, region_b: str = "overlap", method: str = "auto"):
    """Assemble (A_neu, B_neu) dense batches for DDMProblem ``p``.

    region_b: "overlap" (reference NeumannRegion::Overlap for the GEVP rhs)
    or "all" (B == A).  Matrices are produced in the same (optionally
    equilibrated) variables as ``p.A``: congruence scaling leaves the GEVP
    eigenvalues unchanged and maps eigenvectors consistently.

    method: "auto" picks the subtraction fast path when valid (see below),
    "sum"/"subtract" force a path (parity tests).
    """
    from ..obs.logger import scoped as _scoped

    disc, topo = p.disc, p.topo
    rect = getattr(topo, "rect", None)
    # subtraction fast path: A_neu = A_dir(extracted, scatter-free) minus the
    # crossing-stamp corrections — valid when the stamps sum exactly to the
    # global operator, worthwhile when the rect stencil extraction applies
    # (else the big extraction scatter costs what the stamp scatter did)
    fast = _neumann_fast_ok(p)
    if method == "sum":
        fast = False
    elif method == "subtract":
        if not fast:
            raise ValueError("subtraction path preconditions not met")
    with _scoped("Eigensolver", "assemble Neumann"):
        groups = disc.neumann_stamps()
        s_sub = None
        if p.scale is not None:
            s_sub = gather_subdomain(p.scale, batched(topo.sub2glob))
        if fast:
            from ..precond.extract import extract_subdomain_dense

            A_dir = extract_subdomain_dense(
                p.A, batched(topo.sub2glob), batched(topo.valid), None,
                unit_padding_diag=False, rect=rect,
            )
            # B first, then A consuming the extraction last — keeps the
            # peak at 3 live (n_sub, n_pad, n_pad) f64 buffers (4.4 GB at
            # bench scale; each is 1.47 GB)
            if region_b != "all":
                ovlp_mask = topo.bdist <= 2 * topo.overlap
                B_neu = _masked_subtract(p, A_dir, ovlp_mask, groups, s_sub)
            A_neu = _masked_subtract(
                p, A_dir, None, groups, s_sub, donate=True
            )
            del A_dir
            if region_b == "all":
                B_neu = A_neu
        else:
            # the WHOLE stamp-sum assembly (both accumulations + the
            # congruence scaling) runs as ONE jitted program: an eager
            # chain of batch-sized ops keeps intermediates alive across
            # dispatches (it ran out of memory on a 16 GB device at n_pad
            # 1760); inside one executable XLA reuses the buffers
            Ks, ses, sls = [], [], []
            for dofs, K in groups:
                sub_e, sub_l = subdomain_stamp_lists(dofs, topo)
                Ks.append(K)
                ses.append(batched(sub_e))
                sls.append(batched(sub_l))
            ses2 = sls2 = None
            if region_b != "all":
                ovlp_mask = topo.bdist <= 2 * topo.overlap
                ses2, sls2 = [], []
                for dofs, K in groups:
                    sub_e2, sub_l2 = subdomain_stamp_lists(
                        dofs, topo, dof_mask=ovlp_mask
                    )
                    ses2.append(batched(sub_e2))
                    sls2.append(batched(sub_l2))
            A_neu, B_neu = _neumann_sum_jit()(
                tuple(Ks), tuple(ses), tuple(sls), ses2 and tuple(ses2),
                sls2 and tuple(sls2), s_sub, topo.n_sub, topo.n_pad,
            )
            if B_neu is None:
                B_neu = A_neu

        dmask_sub = gather_subdomain(
            p.disc.dirichlet_mask.astype(jnp.float64), batched(topo.sub2glob)
        ) > 0
        pad = ~batched(topo.valid)
        if B_neu is A_neu:
            # region_b == "all" aliases the two; the elimination DONATES its
            # input (in-place, subassembly.py), so eliminate the shared
            # buffer once (B's variant) and add A's extra padding diagonal
            # on a fresh array
            B_neu = eliminate_dirichlet_dense(B_neu, dmask_sub)
            A_neu = B_neu + jnp.eye(B_neu.shape[-1], dtype=B_neu.dtype)[
                None
            ] * pad[:, :, None].astype(B_neu.dtype)
        else:
            A_neu = eliminate_dirichlet_dense(
                A_neu, dmask_sub, unit_diag_padding=pad
            )
            B_neu = eliminate_dirichlet_dense(B_neu, dmask_sub)
        jax.block_until_ready((A_neu, B_neu))
    return A_neu, B_neu


def _neumann_sum_jit():
    """One jitted program for the stamp-sum Neumann assembly: both
    accumulations + the equilibration congruence (see the call site for the
    memory rationale)."""
    import jax
    from functools import partial

    global _NEU_SUM_JIT
    if "_NEU_SUM_JIT" not in globals():

        @partial(jax.jit, static_argnums=(6, 7))
        def f(Ks, ses, sls, ses2, sls2, s_sub, n_sub, n_pad):
            A = jnp.zeros((n_sub, n_pad, n_pad))
            for K, se, sl in zip(Ks, ses, sls):
                A = A + neumann_dense(K, se, sl, n_pad)
            B = None
            if ses2 is not None:
                B = jnp.zeros_like(A)
                for K, se, sl in zip(Ks, ses2, sls2):
                    B = B + neumann_dense(K, se, sl, n_pad)
            if s_sub is not None:
                A = A * s_sub[:, :, None] * s_sub[:, None, :]
                if B is not None:
                    B = B * s_sub[:, :, None] * s_sub[:, None, :]
            return A, B

        _NEU_SUM_JIT = f
    return _NEU_SUM_JIT


def dirichlet_mask_sub(p):
    """(n_sub, n_pad) bool: the subdomain Dirichlet masks, without building
    the dense A_dir batch (callers on the Minv-reuse extension path need only
    the mask — the (n_sub, p, p) f64 batch is ~1.5 GB at bench scale)."""
    topo = p.topo
    dmask_sub = gather_subdomain(
        p.disc.dirichlet_mask.astype(jnp.float64), batched(topo.sub2glob)
    ) > 0
    return dmask_sub & batched(topo.valid)


def dirichlet_dense(p):
    """Dense batch of overlapping Dirichlet matrices A_dir (in the same,
    optionally equilibrated, variables as p.A) + the subdomain Dirichlet
    masks.  Used by the extension/ring/msgfem/svd coarse spaces."""
    from ..core.indexmaps import extraction_map
    from ..precond.extract import extract_subdomain_dense, rect_extract_ok

    topo = p.topo
    rect = getattr(topo, "rect", None)
    lc = None
    if not rect_extract_ok(p.A, rect, topo.n_pad):
        lc = batched(extraction_map(topo, np.asarray(p.A.colsT).T))
    A_dir = extract_subdomain_dense(
        p.A, batched(topo.sub2glob), batched(topo.valid), lc, rect=rect,
    )
    dmask_sub = gather_subdomain(
        p.disc.dirichlet_mask.astype(jnp.float64), batched(topo.sub2glob)
    ) > 0
    dmask_sub = dmask_sub & batched(topo.valid)
    return A_dir, dmask_sub


def _neumann_fast_ok(p) -> bool:
    """Preconditions of the A_dir-subtraction Neumann assembly (see
    :func:`neumann_matrices`)."""
    from ..precond.extract import rect_extract_ok

    return (
        getattr(p.disc, "stamps_cover_operator", False)
        and rect_extract_ok(p.A, getattr(p.topo, "rect", None), p.topo.n_pad)
    )


def _sub_group_jit():
    """In-place (donated) subtraction of crossing-stamp blocks from a dense
    batch: entries touching the dump slot (>= n_pad) zero out and clamp, so
    no padded canvas copy is needed — one small scatter, no full-size dense
    passes."""
    import functools

    import jax

    @functools.partial(jax.jit, donate_argnums=(0,))
    def run(A, Ks, locs):
        n_pad = A.shape[-1]
        drop = locs >= n_pad
        locc = jnp.minimum(locs, n_pad - 1)
        Ksz = jnp.where(drop[:, :, :, None] | drop[:, :, None, :], 0.0, Ks)
        s_idx = jnp.arange(A.shape[0])[:, None, None, None]
        return A.at[s_idx, locc[:, :, :, None], locc[:, :, None, :]].add(-Ksz)

    return run


_SUB_GROUP = None


def _masked_subtract(p, A_dir, mask_np, groups, s_sub, donate=False):
    """Region Neumann matrix by subtraction: restrict the extracted A_dir to
    the masked dof pairs and subtract the stamps that cross the region
    boundary (1..nl-1 dofs inside) — every element contributing to an
    inside pair is either fully inside (keep) or crossing (subtract).
    mask_np None means the full subdomain.  With donate=True, A_dir's buffer
    is consumed (the caller must not use it afterwards)."""
    from ..fem.subassembly import crossing_stamp_lists

    global _SUB_GROUP
    if _SUB_GROUP is None:
        _SUB_GROUP = _sub_group_jit()
    topo = p.topo
    A = A_dir
    if mask_np is not None:
        bm = batched(np.asarray(mask_np) & topo.valid)
        A = jnp.where(bm[:, :, None] & bm[:, None, :], A_dir, 0.0)
    elif not donate:
        A = A_dir + 0.0  # private buffer for the in-place subtraction
    for dofs, K in groups:
        ce, cl = crossing_stamp_lists(dofs, topo, dof_mask=mask_np)
        nl = K.shape[-1]
        Kp = jnp.concatenate([K, jnp.zeros((1, nl, nl), K.dtype)])
        Ks = Kp[batched(ce)]  # (n_sub, max_e, nl, nl) — small
        cl_j = batched(cl)
        if s_sub is not None:  # match A_dir's equilibrated variables,
            # scaled on the small blocks instead of a full dense pass
            sp = jnp.concatenate(
                [s_sub, jnp.zeros((s_sub.shape[0], 1), s_sub.dtype)], axis=1
            )
            n_sub, max_e, _ = cl.shape
            sl = jnp.take_along_axis(
                sp, cl_j.reshape(n_sub, -1), axis=1
            ).reshape(n_sub, max_e, nl)
            Ks = Ks * sl[..., :, None] * sl[..., None, :]
        A = _SUB_GROUP(A, Ks, cl_j)
    return A


def region_neumann(p, dof_mask, method: str = "auto"):
    """Neumann matrix of a sub-region: element/face stamps fully inside the
    per-subdomain dof mask (reference: the matrix_size_eq_subdomain=false
    ring assembly path, examples/pdelab_helper.hh:343-396 — here kept at full
    padded size with zeros outside the region).

    method as in :func:`neumann_matrices`: "auto" uses the A_dir-subtraction
    form when valid (rings: crossing stamps are two perimeters vs the full
    ring area, and the dense extraction is scatter-free on the rect canvas).
    """
    disc, topo = p.disc, p.topo
    groups = disc.neumann_stamps()
    fast = _neumann_fast_ok(p) if method == "auto" else (method == "subtract")
    s_sub = None
    if p.scale is not None:
        s_sub = gather_subdomain(p.scale, batched(topo.sub2glob))
    if fast:
        from ..precond.extract import extract_subdomain_dense

        A_dir = extract_subdomain_dense(
            p.A, batched(topo.sub2glob), batched(topo.valid), None,
            unit_padding_diag=False, rect=topo.rect,
        )
        A = _masked_subtract(p, A_dir, np.asarray(dof_mask), groups, s_sub)
    else:
        A = jnp.zeros((topo.n_sub, topo.n_pad, topo.n_pad))
        for dofs, K in groups:
            se, sl = subdomain_stamp_lists(
                dofs, topo, dof_mask=np.asarray(dof_mask)
            )
            A = A + neumann_dense(K, batched(se), batched(sl), topo.n_pad)
        if s_sub is not None:
            A = scale_matrix_with_pou(A, s_sub, donate=True)
    dmask_sub = gather_subdomain(
        p.disc.dirichlet_mask.astype(jnp.float64), batched(topo.sub2glob)
    ) > 0
    A = eliminate_dirichlet_dense(A, dmask_sub & batched(topo.valid))
    return A


def algebraic_neumann(p):
    """Matrix-only Neumann approximation (Al Daas/Jolivet/Rees):
    A_neu = A_dir - diag(corrections), corrections[i] = sum of |A[i,j]| over
    couplings j outside the subdomain, applied at non-Dirichlet boundary
    rows (coarse_spaces.hh:98-206 semantics, computed globally)."""
    from ..core.indexmaps import extraction_map
    from ..precond.extract import extract_subdomain_dense

    topo = p.topo
    ell = p.A
    lc = extraction_map(topo, np.asarray(ell.colsT).T)
    A_dir = extract_subdomain_dense(
        ell, batched(topo.sub2glob), batched(topo.valid), batched(lc),
        rect=getattr(topo, "rect", None),
    )
    # row sums of |A[i, j]| for j OUTSIDE the subdomain: total |row| minus
    # in-subdomain |row|
    n = ell.n
    rows = jnp.minimum(batched(topo.sub2glob), n - 1)
    row_vals, _ = ell.rows_dense_gather(rows)  # (n_sub, n_pad, m)
    abs_vals = jnp.abs(row_vals)
    total = abs_vals.sum(axis=2)
    inside = jnp.abs(A_dir).sum(axis=2)
    # the diagonal appears in both; difference = off-subdomain couplings
    corr = total - inside
    dmask_sub = gather_subdomain(
        p.disc.dirichlet_mask.astype(jnp.float64), batched(topo.sub2glob)
    ) > 0
    corr = jnp.where(dmask_sub | ~batched(topo.valid), 0.0, corr)
    eye = jnp.eye(topo.n_pad, dtype=A_dir.dtype)
    return A_dir - eye[None] * corr[:, :, None], A_dir


def geneo_coarse_space(
    p,
    ptree: ParamTree,
    algebraic: bool = False,
    constrained: bool = False,
) -> CoarseBasis:
    """p: api.DDMProblem.  Config subtree: ``geneo.eigensolver`` (or
    ``algebraic_geneo.eigensolver`` / ``constraint_geneo.eigensolver``)."""
    prefix = (
        "algebraic_geneo" if algebraic
        else ("constraint_geneo" if constrained else "geneo")
    )
    params = EigensolverParams.from_ptree(ptree.sub(f"{prefix}.eigensolver"))
    pou = batched(p.pou)
    if algebraic:
        # reference (disabled AlgebraicGenEOCoarseSpace, coarse_spaces.hh:
        # 369-377): lhs = algebraic Neumann, rhs = overlapping Dirichlet
        # matrix
        A_neu, A_dir = algebraic_neumann(p)
        B = A_dir
    else:
        A_neu, B = neumann_matrices(p)
    # donate: B is not used past this point (12.3 GB of live batches
    # otherwise at 3-D bench scale)
    C = scale_matrix_with_pou(B, pou, donate=not algebraic)
    spd = (not algebraic) and getattr(p.disc, "definite", True)
    from ..eigen import solve_gevp
    from ..obs.logger import scoped
    from ..solvers.direct import chunked_batch

    with scoped("Eigensolver", "solve GEVP"):
        jfn = lambda A_, C_: solve_gevp(A_, C_, params, spd=spd)
        lam, V, active = chunked_batch(jfn, A_neu, C)
        jax.block_until_ready((lam, V, active))
    if constrained:
        # interior-constraint correction (ConstraintGenEOCoarseSpace,
        # coarse_spaces.hh:425-481): each eigenvector's interior is replaced
        # by its A_dir-harmonic extension X_i = -A_ii^{-1} A_ib X_b, where
        # "interior" = dofs off the subdomain boundary.  The shipped
        # reference constructs this callback but its solve_gevp discards it
        # (eigensolvers.hh:26-38); here the capability is real — one batched
        # masked solve over all subdomains and eigenvectors at once.
        from .extension import energy_minimal_extension

        with scoped("Eigensolver", "constraint solve"):
            A_dir, _ = dirichlet_dense(p)
            interior = batched(p.topo.valid & ~np.asarray(p.topo.boundary))
            V = energy_minimal_extension(A_dir, interior, V)
            V = jnp.where(active[:, :, None], V, 0.0)
            jax.block_until_ready(V)
    return finalize_basis(V, pou, batched(p.topo.valid), active)
