"""Two-level Schwarz orchestration.

The analogue of ``TwoLevelSchwarzPreconditioner``
(examples/pdelab_schwarz.hh:26-205): wires fine-level Schwarz + coarse space
+ Galerkin correction into one combined preconditioner, dispatching the
coarse space on ``coarsespace.type`` (SURVEY.md §5.6 key inventory).

Multi-device note: this module needs no sharding-specific code — under
``api.build_preconditioner(p, mesh=...)`` the whole build runs inside a
``core.mesh.setup_sharding`` context and every batched stage below
partitions over the subdomain mesh axis via GSPMD (the reference's
all-ranks-parallel setup, galerkin_preconditioner.hh:219-349, expressed as
sharding propagation instead of MPI).
"""

from __future__ import annotations

from ..config import ParamTree
from .combined import build_combined
from .galerkin import build_galerkin
from .schwarz import SchwarzPreconditioner, build_schwarz


def build_coarse_space(p, cs_type: str, ptree: ParamTree, fine=None):
    """Dispatch like pdelab_schwarz.hh:93-141's coarse-space switch."""
    from ..coarse import pou_coarse_space

    if cs_type == "pou":
        templates = None
        if p.disc.n_comp > 1:
            from ..coarse.pou_space import rigid_body_modes

            templates = rigid_body_modes(p.disc.grid.nodes, p.disc.n_comp)
        return pou_coarse_space(
            p.topo, p.pou, templates=templates,
            dirichlet_mask=p.disc.dirichlet_mask,
        )
    if cs_type in ("geneo", "algebraic_geneo"):
        from ..coarse.geneo import geneo_coarse_space

        return geneo_coarse_space(p, ptree, algebraic=cs_type == "algebraic_geneo")
    if cs_type == "geneo_ring":
        from ..coarse.ring import geneo_ring_coarse_space

        # the fine level is passed so the ring extension can reuse its
        # explicit inverse (coarse/extension.py:inverse_harmonic_extension)
        return geneo_ring_coarse_space(p, ptree, fine=fine)
    if cs_type in ("msgfem", "algebraic_msgfem", "msgfem_euclid"):
        from ..coarse.msgfem import msgfem_coarse_space

        return msgfem_coarse_space(p, ptree, variant=cs_type)
    if cs_type == "msgfem_ring":
        from ..coarse.ring import msgfem_ring_coarse_space

        return msgfem_ring_coarse_space(p, ptree, fine=fine)
    if cs_type == "harmonic_extension":
        from ..coarse.harmonic import harmonic_extension_coarse_space

        return harmonic_extension_coarse_space(p, ptree)
    if cs_type == "svd":
        from ..coarse.svd import svd_coarse_space

        return svd_coarse_space(p, ptree)
    if cs_type == "constraint_geneo":
        from ..coarse.geneo import geneo_coarse_space

        return geneo_coarse_space(p, ptree, constrained=True)
    raise ValueError(f"Unknown coarse space type '{cs_type}'")


# coarse spaces whose construction REUSES the fine level's explicit inverse
# (ring extensions, coarse/extension.py:inverse_harmonic_extension) — these
# need the fine preconditioner built first; all others build the coarse
# basis BEFORE the fine factorization so the peak HBM holds either the GEVP
# pencils or the fine inverse, never both (at 3-D bench scale each
# (512, 1000, 1000) f64 batch is 4.1 GB and inverse + A_dir + B_neu +
# A_neu exceeded a 16 GB device)
_CS_NEEDS_FINE = {"geneo_ring", "msgfem_ring"}


def build_two_level(p, fine: SchwarzPreconditioner | None = None):
    """p: api.DDMProblem.  Returns the combined two-level preconditioner."""
    ptree = p.ptree
    cs_type = ptree.sub("coarsespace").get("type", "geneo")
    if cs_type == "none":
        return fine if fine is not None else build_schwarz(
            p.A, p.topo, p.pou, ptree
        )
    if fine is None and cs_type in _CS_NEEDS_FINE:
        fine = build_schwarz(p.A, p.topo, p.pou, ptree)
    basis = build_coarse_space(p, cs_type, ptree, fine=fine)
    coarse_ptree = ptree if "coarse_solver.type" in ptree else None
    # every coarse space built here is POU-finalized (vanishes on subdomain
    # boundaries), so the pairwise-local coarse matrix is exact — and far
    # cheaper than the scan-of-SpMVs formulation (galerkin_coarse_matrix_pairs).
    # A coarse space without that invariant must clear basis.boundary_vanishing
    # and gets the always-exact global formula instead.
    method = ptree.sub("coarse_solver").get("matrix_method", "pairs")
    if method == "pairs" and not basis.boundary_vanishing:
        method = "global"
    coarse = build_galerkin(p.A, p.topo, basis, coarse_ptree, method=method)
    if fine is None:
        # the fine factorization comes LAST: the pairs coarse matrix needs
        # a dense-batch extraction of its own, and holding the fine
        # explicit inverse next to it exceeded a 16 GB device at 3-D bench scale
        fine = build_schwarz(p.A, p.topo, p.pou, ptree)
    op = p.A if ptree.sub("combined_preconditioner").get("mode", "additive") == "multiplicative" else None
    return build_combined([fine, coarse], ptree, op=op)
