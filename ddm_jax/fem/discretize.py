"""Discretization driver: grid + problem -> global system + DDM inputs.

The analogue of the reference's ``GenericDDMProblem``
(examples/generic_ddm_problem.hh:48-407): owns the function space (here:
nodal P1/Q1 dofs), constraints (Dirichlet masks + interpolated boundary
values), and assembly of the global operator, and feeds the DDM layers.

The constrained system follows the standard correction form: with ``g`` the
Dirichlet interpolant (nonzero only at constrained dofs), solve

    A_c z = b - A g,   rhs zeroed at Dirichlet dofs,  u = g + z

where A_c is the symmetrically-eliminated matrix
(examples/pdelab_helper.hh:33-46 semantics).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sps

from ..core.sparse import EllPattern, SparseELL, eliminate_dirichlet
from .assemble import (
    ElementQuadrature,
    assemble_convection_diffusion,
    assemble_linear_elasticity,
    element_coo_indices,
)
from .grids import Grid
from .problems import ElasticityProblem, Problem


@dataclass
class Discretization:
    grid: Grid
    problem: Problem | ElasticityProblem
    n_comp: int = 1
    #: polynomial degree: 1 (P1/Q1 on mesh vertices) or 2 (Pk/Qk via
    #: fem/highorder.py edge/center dofs — reference: PkLocalFiniteElementMap
    #: degree 2, nonlinearpoisson.cc:104)
    degree: int = 1
    #: subdomain Neumann matrices are SPSD (CG elements are elementwise PSD);
    #: DG overrides this — partial SIPG face sums can be slightly indefinite
    definite: bool = True

    def __post_init__(self):
        if self.degree == 1:
            self._elem_nodes = self.grid.elems
            self._node_coords = self.grid.nodes
            self._node_boundary = self.grid.boundary_nodes()
            basis = self.grid.elem_type
        elif self.degree == 2:
            from .highorder import p2_dofs

            (self._elem_nodes, self._node_coords, self._node_boundary,
             basis) = p2_dofs(self.grid)
        else:
            raise NotImplementedError(f"degree {self.degree}")
        self.quad = ElementQuadrature(basis)
        self.xe = jnp.asarray(self._node_coords[self._elem_nodes])
        self.n_dofs = self._node_coords.shape[0] * self.n_comp
        rows, cols = element_coo_indices(self._elem_nodes, self.n_comp)
        self.pattern = EllPattern.from_coo(rows, cols, self.n_dofs)
        self._dof_scatter = jnp.asarray(
            self.dof_tuples().reshape(-1), dtype=np.int32
        )

    # -- masks / boundary data --------------------------------------------
    @cached_property
    def dirichlet_mask(self) -> jnp.ndarray:
        """(n_dofs,) bool — physical-boundary dofs selected by the problem."""
        xs = jnp.asarray(self._node_coords)
        node_mask = jnp.asarray(self._node_boundary) & self.problem.is_dirichlet(
            xs
        )
        if self.n_comp == 1:
            return node_mask
        return jnp.repeat(node_mask, self.n_comp)

    @cached_property
    def dirichlet_values(self) -> jnp.ndarray:
        xs = jnp.asarray(self._node_coords)
        g = self.problem.g(xs)
        if self.n_comp == 1:
            gv = g
        else:
            gv = g.reshape(-1)
        return jnp.where(self.dirichlet_mask, gv, 0.0)

    # -- assembly ----------------------------------------------------------
    def element_matrices(self, problem: Problem | ElasticityProblem | None = None,
                         elems: np.ndarray | None = None):
        """Batched (Ke, fe); re-run with a modified problem (e.g.
        ``problem.symmetrized()``) for eigenproblem operators.

        elems: optional element-id subset — assemble only those elements
        (the Neumann subtraction path needs stamps for the boundary-crossing
        elements only, ~1/6 of the mesh at bench scale)."""
        p = problem or self.problem
        # the element matrices of the (linear) discretization's own problem
        # are immutable — cache them so the Neumann assembly in the GEVP
        # phase does not redo the global assembly's work (19 MB at bench
        # scale)
        cacheable = elems is None and p is self.problem
        if cacheable and getattr(self, "_Ke_cache", None) is not None:
            return self._Ke_cache
        xe = self.xe if elems is None else self.xe[np.asarray(elems)]
        if isinstance(p, ElasticityProblem):
            out = assemble_linear_elasticity(self.quad, xe, p.lam, p.mu, p.f)
        else:
            out = assemble_convection_diffusion(
                self.quad, xe, p.alpha, p.b, p.c, p.f
            )
        if cacheable:
            self._Ke_cache = out
        return out

    def assemble(self, problem=None) -> tuple[SparseELL, jnp.ndarray]:
        """Unconstrained global (A, b)."""
        Ke, fe = self.element_matrices(problem)
        A = self.pattern.assemble(Ke.reshape(-1))
        b = jnp.zeros(self.n_dofs, Ke.dtype).at[self._dof_scatter].add(fe.reshape(-1))
        return A, b

    def constrained_system(self, problem=None):
        """(A_c, rhs, g) with symmetric Dirichlet elimination."""
        A, b = self.assemble(problem)
        g = self.dirichlet_values
        rhs = b - A.mv(g)
        rhs = jnp.where(self.dirichlet_mask, 0.0, rhs)
        Ac = eliminate_dirichlet(A, self.dirichlet_mask)
        return Ac, rhs, g

    # -- DDM inputs --------------------------------------------------------
    def dof_tuples(self) -> np.ndarray:
        """(n_elems, nl) global dof ids per element — the unit of dof
        membership/ownership for the DDM topology."""
        if self.n_comp == 1:
            return self._elem_nodes
        return (
            self._elem_nodes[:, :, None] * self.n_comp + np.arange(self.n_comp)
        ).reshape(self.grid.n_elems, -1)

    @property
    def stamps_cover_operator(self) -> bool:
        """True when ``neumann_stamps()`` sums exactly to the assembled
        global operator (pre-elimination) — the requirement of the Neumann
        subtraction fast path (coarse/geneo.py:neumann_matrices).  CG
        assembly is a pure element sum, so this holds whenever the stamps
        use the same operator as ``assemble`` (i.e. the problem is already
        symmetric; nonsymmetric problems stamp the symmetrized operator)."""
        return getattr(self.problem, "symmetric", True) is not False

    def neumann_stamps(self, problem=None):
        """Assembly stamps for subdomain Neumann matrices: list of
        (global dof tuples (n_stamps, nl) numpy, blocks (n_stamps, nl, nl)
        device array).  CG: one group, the element matrices.  Nonsymmetric
        problems use the symmetrized (elliptic) operator, mirroring the
        two-operator machinery of generic_ddm_problem.hh:169-220."""
        p = problem or self.problem
        if getattr(p, "symmetric", True) is False:
            p = p.symmetrized()
        Ke, _ = self.element_matrices(p)
        return [(self.dof_tuples(), Ke)]

    def adjacency(self) -> sps.csr_matrix:
        """Structurally-symmetric matrix-graph adjacency (pattern only)."""
        p = self.pattern
        return sps.csr_matrix(
            (np.ones(p.rows_csr.size), (p.rows_csr, p.cols_csr)),
            shape=(self.n_dofs, self.n_dofs),
        )
