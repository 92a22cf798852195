"""Convenience API: one-call setup of DDM solvers for the shipped problems.

The analogue of the reference's example drivers (examples/poisson.cc,
pdelab_example.cc): wire grid -> discretization -> topology -> POU ->
preconditioners -> Krylov solve from one config tree, with the same key names
(SURVEY.md §5.6).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .config import ParamTree
from .core.indexmaps import DDMTopology, pou_weights
from .core.setup import setup_topology
from .core.sparse import SparseELL
from .fem import problems as problems_mod
from .fem.discretize import Discretization
from .fem.grids import structured_grid
from .fem.msh import read_msh
from .precond.schwarz import SchwarzPreconditioner, build_schwarz
from .solvers.krylov import (
    KrylovResult,
    operator_of,
    prec_of,
    solve_from_config,
)


def default_ptree() -> ParamTree:
    return ParamTree(
        {
            "overlap": 2,
            "solver": {"type": "restartedgmressolver", "reduction": 1e-10,
                       "maxit": 1000, "restart": 50},
            "schwarz": {"type": "restricted",
                        "subdomain_solver": {"type": "cholesky"}},
            "pou": {"type": "distance", "shrink": 0},
            "coarsespace": {"type": "none"},
        }
    )


@dataclass
class DDMProblem:
    """Everything needed to run solves on one assembled problem.

    ``A``/``rhs`` are the (optionally Jacobi-equilibrated) constrained system;
    ``scale`` transforms solutions back (x = scale * z, None if not
    equilibrated)."""

    disc: Discretization
    topo: DDMTopology
    A: SparseELL
    rhs: jnp.ndarray
    g: jnp.ndarray
    pou: np.ndarray
    ptree: ParamTree
    elem_part: np.ndarray
    scale: jnp.ndarray | None = None


def make_grid(ptree: ParamTree, dim: int = 2):
    """Grid from config (reference: ddm_utilities.hh:33-171 make_grid):
    ``meshfile`` if present, else a structured grid with ``gridsize`` cells
    per axis, optionally refined."""
    meshfile = ptree.get("meshfile", "")
    if meshfile:
        grid = read_msh(meshfile)
    else:
        gs = ptree.get("gridsize", 64)
        grid = structured_grid((gs,) * dim)
    refine_n = ptree.get("refine", 0)
    if refine_n:
        from .fem.grids import refine

        grid = refine(grid, refine_n)
    return grid


def setup_problem(
    ptree: ParamTree | None = None,
    problem=None,
    grid=None,
    n_sub: int | None = None,
    parts: tuple[int, ...] | None = None,
    n_comp: int = 1,
) -> DDMProblem:
    from .obs.logger import scoped

    ptree = ptree or default_ptree()
    problem = problem or problems_mod.PROBLEMS[ptree.get("problem", "simple")]()
    with scoped("Setup", "grid (host)"):
        grid = grid if grid is not None else make_grid(ptree)
    overlap = ptree.get("overlap", 2)
    with scoped("Setup", "discretize (host pattern)"):
        disc = Discretization(grid, problem, n_comp=n_comp)
    with scoped("Setup", "assemble + constrain"):
        A, rhs, g = disc.constrained_system()
        jax.block_until_ready((A.valsT, rhs, g))
    scale = None
    if ptree.get("equilibrate", True):
        from .core.sparse import jacobi_equilibrate

        with scoped("Setup", "equilibrate"):
            A, rhs, scale = jacobi_equilibrate(A, rhs)
            jax.block_until_ready((A.valsT, rhs))
    if parts is None and n_sub is None:
        n_sub = ptree.get("subdomains", 4)
    with scoped("Setup", "topology (host)"):
        topo, elem_part = setup_topology(
            disc, overlap=overlap, n_sub=n_sub, parts=parts
        )
    with scoped("Setup", "pou (host)"):
        pou = pou_weights(
            topo,
            ptree.sub("pou").get("type", "distance"),
            shrink=ptree.sub("pou").get("shrink", 0),
        )
    return DDMProblem(
        disc=disc, topo=topo, A=A, rhs=rhs, g=g, pou=pou, ptree=ptree,
        elem_part=elem_part, scale=scale,
    )


def build_preconditioner(p: DDMProblem, mesh=None, axis: str = "sub"):
    """One- or two-level preconditioner per config (coarsespace.type).

    With ``mesh`` given, the ENTIRE setup phase — subdomain extraction,
    batched factorization, eigensolves, coarse-basis finalization and the
    coarse matrix — runs with the subdomain batch sharded over the mesh axis
    (core/mesh.py setup_sharding): every builder commits its batched inputs,
    and XLA partitions the downstream computation across devices, the GSPMD
    equivalent of the reference's all-ranks-parallel setup
    (schwarz.hh:85-92, coarse_spaces.hh:319-331,
    galerkin_preconditioner.hh:219-349).  Pass the same mesh to
    :func:`solve`."""
    from contextlib import nullcontext

    cs_type = p.ptree.sub("coarsespace").get("type", "none")
    if mesh is not None:
        from .core.mesh import setup_sharding

        ctx = setup_sharding(mesh, p.topo.n_sub, axis)
    else:
        ctx = nullcontext()
    with ctx:
        if cs_type == "none":
            prec = build_schwarz(p.A, p.topo, p.pou, p.ptree)
        else:
            # build_two_level orders the fine factorization vs the coarse
            # basis construction to minimize peak HBM (see _CS_NEEDS_FINE)
            from .precond.two_level import build_two_level

            prec = build_two_level(p)
    if mesh is not None:
        from .core.mesh import shard_batched

        # normalise: everything subdomain-batched sharded, the rest (global
        # maps, the replicated coarse factor) replicated
        prec = shard_batched(prec, mesh, p.topo.n_sub, axis)
    return prec


def solve(p: DDMProblem, prec=None, mesh=None, axis: str = "sub") -> KrylovResult:
    """Krylov solve from config.  With ``mesh`` given, runs under shard_map
    over the subdomain mesh axis (the multi-chip path, SURVEY.md §2.6) —
    same iterates, distributed preconditioner state."""
    prec = prec if prec is not None else build_preconditioner(p, mesh=mesh, axis=axis)
    x0 = jnp.zeros_like(p.rhs)
    if mesh is not None:
        from .core.mesh import solve_sharded

        return solve_sharded(
            p.A, prec, p.rhs, x0, p.ptree, mesh, p.topo.n_sub, axis
        )
    res = solve_from_config(
        operator_of(p.A), prec_of(prec), p.rhs, x0, p.ptree, "solver"
    )
    return res


def solution(p: DDMProblem, res: KrylovResult) -> jnp.ndarray:
    """Assemble the full solution u = g + (scale*) z."""
    z = res.x if p.scale is None else p.scale * res.x
    return p.g + z
