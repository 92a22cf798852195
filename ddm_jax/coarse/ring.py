"""Ring coarse spaces: eigenproblems restricted to the overlap ring +
energy-minimal extension to the interior.

Rebuilds GenEORingCoarseSpace (coarse_spaces.hh:502-648) and
MsGFEMRingCoarseSpace (coarse_spaces.hh:913-1163) — the reference's principal
"make the expensive part smaller" device (SURVEY.md §5.7): the per-subdomain
eigenproblem shrinks from subdomain size to the overlap-ring size, and the
eigenvectors are extended energy-minimally inward.

All of the reference's index bookkeeping (ring_to_subdomain maps, reordering,
hash sets for boundary layers) collapses into boolean masks on the padded
dense batch:

* geneo_ring: ring = bdist <= 2*overlap + 1 (NeumannRegion::ExtendedOverlap,
  pdelab_schwarz.hh:66); eigenproblem (A_ring, mod_pou-scaled A_ring) with
  mod_pou zeroed outside the ring and on its inner boundary; extension with
  Dirichlet data one layer inside the inner ring boundary
  (coarse_spaces.hh:572-598).
* msgfem_ring: ring = bdist <= 2*overlap (NeumannRegion::Overlap); ring_width
  = 2*overlap - 2*shrink; A-harmonicity constraint on the ring interior; B
  weighted by mod_pou zeroed at bdist >= shrink + ring_width; extension from
  the bdist == shrink + ring_width - 1 layer (coarse_spaces.hh:1098-1110).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.mesh import batched
import numpy as np

from ..config import ParamTree
from ..eigen import solve_gevp
from ..eigen.params import EigensolverParams
from ..fem.subassembly import scale_matrix_with_pou
from .basis import finalize_basis
from .geneo import dirichlet_mask_sub, region_neumann


def _adjacent_to(
    topo, local_cols: np.ndarray, target_mask: np.ndarray, within: np.ndarray
) -> np.ndarray:
    """(n_sub, n_pad) bool: dofs in ``within`` with a matrix-graph neighbour
    in ``target_mask``.  ``local_cols`` is the subdomain-local extraction map
    (core/indexmaps.py:extraction_map of the problem's column array)."""
    tm = np.concatenate([target_mask, np.zeros((topo.n_sub, 1), bool)], axis=1)
    hit = np.take_along_axis(
        tm, local_cols.reshape(topo.n_sub, -1), axis=1
    ).reshape(local_cols.shape)
    return within & hit.any(axis=2)


def _ring_extension(p, ptree, ext_cfg, ext_free, data, fine, local_cols=None):
    """Energy-minimal extension for ring spaces, dispatching on
    ``<cs>.extension.mode``:

    * ``pcg`` / ``auto`` (default): CG on the compacted free block
      preconditioned by the fine level's explicit subdomain inverse — no
      second f64 factorization (extension.py:energy_minimal_extension_pcg).
      The result is VERIFIED (max relative residual fetched to host); on
      poor contraction, or when no compatible inverse is held, ``auto``
      falls back to the direct factorization.
    * ``direct``: batched f64 Cholesky/LU of the free block at compact size
      (the reference's dedicated UMFPACK factorization,
      energy_minimal_extension.hh:78-88).

    Do NOT revert to the Minv-reuse Schur trick
    (inverse_harmonic_extension): its eps*cond^2 error was O(1) with a
    double-single f64 at flagship subdomain conditioning and stalled GMRES
    at 400 iterations (islands 384^2/256) — PCG reuses the same inverse but
    residual-controlled, so inverse noise affects only the rate.
    """
    import numpy as _np

    from ..obs.logger import logger
    from .extension import (
        energy_minimal_extension_pcg,
        energy_minimal_extension_sparse,
        extension_inverse_of,
    )

    mode = ext_cfg.get("mode", "auto")
    accept = float(ext_cfg.get("tolerance", 1e-8))
    precision = ext_cfg.get("precision", "mixed")
    Minv = extension_inverse_of(fine, p, ptree) if mode != "direct" else None
    if Minv is not None:
        # mixed (default): an f32 PCG stage runs to its ~1e-5 true-residual
        # floor, then a warm-started f64 polish; the f64 stage recomputes
        # the residual so the f32 stage only saves f64 iterations.  Attempts are
        # residual-verified: mixed -> full-f64 PCG -> direct factorization.
        maxit = int(ext_cfg.get("maxit", 40))
        attempts = [dict(maxit=int(ext_cfg.get("maxit64", 16)),
                         maxit32=int(ext_cfg.get("maxit32", maxit)))
                    ] if precision == "mixed" else []
        attempts.append(dict(maxit=maxit, maxit32=0))
        for att in attempts:
            ext, rel = energy_minimal_extension_pcg(
                p.A, p.topo, ext_free, data, Minv, local_cols=local_cols,
                # measured (islands 48^2/16, contrast 1e6): 1.95e-6 at 16
                # iterations, 3e-11 at 24 — 40 leaves margin and the
                # verified fallback covers pathological pencils
                **att,
            )
            worst = float(_np.max(_np.asarray(rel)))
            if worst <= accept:
                return ext
            logger.warn(
                "ring extension PCG (maxit={}, maxit32={}) stalled (max rel "
                "residual {:.2e} > {:.0e}); escalating",
                att["maxit"], att["maxit32"], worst, accept,
            )
    return energy_minimal_extension_sparse(
        p.A, p.topo, ext_free, data, local_cols=local_cols,
        solver_type="cholesky" if getattr(p.disc, "definite", True) else "lu",
    )


def geneo_ring_coarse_space(p, ptree: ParamTree, fine=None):
    from ..core.indexmaps import extraction_map
    from ..obs.logger import scoped
    from ..solvers.direct import chunked_batch
    from .extension import compact_maps, compact_mat, expand_rows

    topo = p.topo
    es = ptree.sub("geneo_ring.eigensolver")
    params = EigensolverParams.from_ptree(es)
    ext_cfg = ptree.sub("geneo_ring.extension")
    # thin-annulus ring pencils need the larger mixed-precision
    # refinement budget for exact kept spans (params.py, offline grid);
    # an EXPLICIT config value wins over the floor (perf sweeps)
    params = params.with_refine(
        params.refine_iters if "refine_iters" in es
        else max(params.refine_iters, 4),
        params.refine_buf if "refine_buf" in es
        else max(params.refine_buf, 24))
    pou = batched(p.pou)
    valid = topo.valid
    local_cols = extraction_map(topo, np.asarray(p.A.colsT).T)

    ring = valid & (topo.bdist <= 2 * topo.overlap + 1)
    not_ring = valid & ~ring
    # inner ring boundary: ring dofs with a neighbour outside the ring
    irb = _adjacent_to(topo, local_cols, not_ring, ring)
    # layer one inside the ring: ring\irb dofs adjacent to irb
    inside_rb = _adjacent_to(topo, local_cols, irb, ring & ~irb)
    # extension free set: interior + inner ring boundary
    ext_free = not_ring | irb

    # compact the pencil to ring size: the reference's whole point for rings
    # is the smaller eigenproblem (coarse_spaces.hh:502-648); at bench scale
    # the ring is ~0.55x the padded subdomain, so eigh costs ~0.18x
    idx, cval, pos, _r_pad = compact_maps(ring)
    idx_j, cval_j, pos_j = batched(idx), batched(cval), batched(pos)

    with scoped("Eigensolver", "assemble Neumann"):
        A_ring = region_neumann(p, ring)
        A_rc = compact_mat(A_ring, idx_j)
        del A_ring
        jax.block_until_ready(A_rc)
    keep = cval_j[:, :, None] & cval_j[:, None, :]
    A_rc = jnp.where(keep, A_rc, 0.0)
    A_eig = A_rc + jnp.eye(A_rc.shape[-1])[None] * (~cval_j)[:, :, None]

    mod_pou = jnp.where(batched(ring & ~irb), pou, 0.0)
    mp_c = jnp.take_along_axis(mod_pou, idx_j, axis=1)
    C = scale_matrix_with_pou(A_rc, mp_c)

    spd = getattr(p.disc, "definite", True)
    with scoped("Eigensolver", "solve GEVP"):
        jfn = lambda A_, C_: solve_gevp(A_, C_, params, spd=spd)
        lam, V_c, active = chunked_batch(jfn, A_eig, C)
        jax.block_until_ready((lam, V_c, active))
    V_ring = expand_rows(V_c, pos_j)

    data = jnp.where(batched(inside_rb)[:, None, :], V_ring, 0.0)
    with scoped("Eigensolver", "extension"):
        ext = _ring_extension(
            p, ptree, ext_cfg, ext_free, data, fine, local_cols
        )
        jax.block_until_ready(ext)
    combined = jnp.where(batched(ext_free)[:, None, :], ext, V_ring)
    combined = jnp.where(batched(valid)[:, None, :], combined, 0.0)
    return finalize_basis(combined, pou, batched(valid), active)


def msgfem_ring_coarse_space(p, ptree: ParamTree, fine=None):
    from ..obs.logger import scoped
    from ..solvers.direct import chunked_batch
    from .extension import (
        compact_maps,
        compact_mat,
        expand_rows,
        harmonic_parameter_basis_compact,
    )

    topo = p.topo
    es = ptree.sub("msgfem_ring.eigensolver")
    params = EigensolverParams.from_ptree(es)
    params = params.with_refine(
        params.refine_iters if "refine_iters" in es
        else max(params.refine_iters, 4),
        params.refine_buf if "refine_buf" in es
        else max(params.refine_buf, 24))
    ext_cfg = ptree.sub("msgfem_ring.extension")
    shrink = ptree.sub("pou").get("shrink", 0)
    pou = batched(p.pou)
    valid = topo.valid
    ov = topo.overlap
    ring_width = 2 * ov - 2 * shrink

    ring = valid & (topo.bdist <= 2 * ov)
    inside_rb = ring & (topo.bdist == 2 * ov)  # innermost ring layer
    # only the Dirichlet MASK is needed up front; the dense A_dir batch
    # (~1.5 GB at bench scale) is built lazily in the no-Minv extension
    # fallback below — building it eagerly OOMed msgfem_ring at 384^2/256
    dmask_np = np.asarray(dirichlet_mask_sub(p))

    # dof classes within the ring (coarse_spaces.hh:986-1001)
    bnd_class = ring & (np.asarray(topo.boundary) | np.asarray(inside_rb)) & ~dmask_np
    int_class = ring & ~bnd_class & ~dmask_np

    # compact everything to ring size (reference keeps ring_to_subdomain
    # index vectors, coarse_spaces.hh:966-1096; here: host compact maps)
    rc = ring & ~dmask_np
    idx, cval, pos, _r_pad = compact_maps(rc)
    idx_j, cval_j, pos_j = batched(idx), batched(cval), batched(pos)

    with scoped("Eigensolver", "assemble Neumann"):
        A_ring = region_neumann(p, ring)
        A_rc = compact_mat(A_ring, idx_j)
        del A_ring
        jax.block_until_ready(A_rc)
    A_rc = jnp.where(cval_j[:, :, None] & cval_j[:, None, :], A_rc, 0.0)

    # mod_pou zeroed at bdist >= shrink + ring_width (coarse_spaces.hh:971-973)
    mod_pou = jnp.where(batched(topo.bdist < shrink + ring_width), pou, 0.0)
    mp_c = jnp.take_along_axis(mod_pou, idx_j, axis=1)
    B_c = scale_matrix_with_pou(A_rc, mp_c)

    int_c = jnp.take_along_axis(batched(int_class), idx_j, axis=1) & cval_j
    par_c = jnp.take_along_axis(batched(bnd_class), idx_j, axis=1) & cval_j
    pidx, pval, _ppos, _b_pad = compact_maps(np.asarray(par_c))
    pidx_j, pval_j = batched(pidx), batched(pval)

    with scoped("Eigensolver", "harmonic basis"):
        A_con = A_rc + jnp.eye(A_rc.shape[-1])[None] * (~cval_j)[:, :, None]
        Hc = harmonic_parameter_basis_compact(A_con, int_c, pidx_j, pval_j)
        jax.block_until_ready(Hc)

    with scoped("Eigensolver", "reduced pencil"):
        # Hc^T A Hc at (r_pad, b_pad) in f64 (wide matmuls); a double-single
        # (dd) formation was measured to NaN the whitened GEVP on this
        # near-singular pencil — keep f64
        T1 = jnp.einsum("spq,sqb->spb", A_rc, Hc)
        Ahat = jnp.einsum("spa,spb->sab", Hc, T1)
        T2 = jnp.einsum("spq,sqb->spb", B_c, Hc)
        Bhat = jnp.einsum("spa,spb->sab", Hc, T2)
        Ahat = 0.5 * (Ahat + Ahat.transpose(0, 2, 1))
        Bhat = 0.5 * (Bhat + Bhat.transpose(0, 2, 1))
        Ahat = Ahat + jnp.eye(Ahat.shape[-1])[None] * (~pval_j)[:, :, None]
        jax.block_until_ready((Ahat, Bhat))

    spd = getattr(p.disc, "definite", True)
    with scoped("Eigensolver", "solve GEVP"):
        jfn = lambda A_, C_: solve_gevp(A_, C_, params, spd=spd)
        lam, W, active = chunked_batch(jfn, Ahat, Bhat)
        jax.block_until_ready((lam, W, active))
    V_c = jnp.einsum("sqb,skb->skq", Hc, W)  # back to ring size
    V_ring = expand_rows(V_c, pos_j)

    # extension from the bdist == shrink + ring_width - 1 layer
    ext_bnd = valid & (topo.bdist == shrink + ring_width - 1)
    ext_free = valid & (topo.bdist > shrink + ring_width - 1)
    data = jnp.where(batched(ext_bnd)[:, None, :], V_ring, 0.0)
    with scoped("Eigensolver", "extension"):
        ext = _ring_extension(p, ptree, ext_cfg, ext_free, data, fine)
        jax.block_until_ready(ext)
    combined = jnp.where(batched(ext_free)[:, None, :], ext, V_ring)
    combined = jnp.where(batched(valid)[:, None, :], combined, 0.0)
    return finalize_basis(combined, pou, batched(valid), active)
