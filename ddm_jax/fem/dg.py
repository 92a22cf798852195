"""Discontinuous Galerkin (Q1 SIPG) discretization on structured 2D grids.

Rebuilds the reference's DG path — PDELab's ConvectionDiffusionDG local
operator with DGLegendreSpace degree 1 on a structured quad grid (reference:
examples/convectiondiffusiondg.cc:36-60) — batched: the skeleton terms are
assembled as fully batched per-face-family kernels (all vertical faces at
once, all horizontal faces at once) instead of an intersection loop.

Method: symmetric interior penalty (SIPG) with coefficient-weighted averages
(SWIP) and upwinded convection, weak Dirichlet (Nitsche) and outflow
boundaries, matching PDELab's scheme structure:

  interior F:  -{a du/dn}_w [v] - {a dv/dn}_w [u] + gamma [u][v]
               + (b.n) u_upwind [v]
  Dirichlet F: -a du/dn v - a dv/dn (u-g) + gamma (u-g) v
               + (b.n)^+ u v + (b.n)^- g v   (g terms -> rhs)
  Outflow  F:  (b.n)^+ u v

with omega_-/+ = delta_+/-/(delta_- + delta_+), delta = n.A n per side
evaluated at element centers, gamma = sigma * harmonic(delta)/h_perp.

The nodal Q1 basis per element is used (same space as the reference's
Legendre modal basis; the assembled operator is related by a fixed local
change of basis which preconditioner quality is invariant to).

Neumann stamps for GenEO (assemblewrapper.hh:271-367 skeleton-correction
analogue): volume+boundary blocks stamp on each element's 4 dofs; each
interior face stamps on its 8 coupled dofs — a face belongs to a subdomain's
Neumann matrix iff both elements are inside, which reproduces the reference's
subtraction of cross-boundary skeleton contributions.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sps

from ..core.sparse import EllPattern, SparseELL
from .assemble import (
    ElementQuadrature,
    assemble_convection_diffusion,
)
from .grids import ELEM_FACES, Grid
from .problems import Problem

_G = 1.0 / np.sqrt(3.0)
_QP = np.array([0.5 - 0.5 * _G, 0.5 + 0.5 * _G])  # 2-pt Gauss on [0,1]
_QW = np.array([0.5, 0.5])


def _trace(side: str, t: np.ndarray):
    """Q1 nodal traces/normal-derivative factors on a face of [0,1]^2.

    t: (q,) coordinates along the face.  Returns (T (q,4) values,
    Gn (q,4) outward-normal ref-derivatives; divide by h_perp for physical).
    Local node order: (x0y0, x1y0, x0y1, x1y1).
    """
    z = np.zeros_like(t)
    o = 1.0 - t
    if side == "x1":  # face x=1, outward n=+x, coord t=y
        T = np.stack([z, o, z, t], -1)
        G = np.stack([-o, o, -t, t], -1)
    elif side == "x0":  # face x=0, n=-x
        T = np.stack([o, z, t, z], -1)
        G = -np.stack([-o, o, -t, t], -1)
    elif side == "y1":  # face y=1, n=+y, t=x
        T = np.stack([z, z, o, t], -1)
        G = np.stack([-o, -t, o, t], -1)
    elif side == "y0":  # face y=0, n=-y
        T = np.stack([o, t, z, z], -1)
        G = -np.stack([-o, -t, o, t], -1)
    else:
        raise ValueError(side)
    return T, G


@dataclass
class DGDiscretization:
    """Q1 SIPG convection-diffusion on a structured 2D quad grid."""

    grid: Grid
    problem: Problem
    sigma: float = 4.0  # penalty parameter (config key dg.alpha-like)
    n_comp: int = 1  # interface parity with Discretization (always 1)
    #: subdomain SIPG Neumann sums lose cross-boundary penalty coupling and
    #: can be slightly indefinite -> eigensolves use the indefinite-safe path
    definite: bool = False

    def __post_init__(self):
        if self.grid.shape is None or len(self.grid.shape) != 2:
            raise NotImplementedError(
                "DGDiscretization currently supports structured 2D quad grids"
            )
        self.nx, self.ny = self.grid.shape
        lo = self.grid.nodes.min(axis=0)
        hi = self.grid.nodes.max(axis=0)
        self.hx = (hi[0] - lo[0]) / self.nx
        self.hy = (hi[1] - lo[1]) / self.ny
        self.lo = lo
        self.n_dofs = 4 * self.grid.n_elems
        self.quad = ElementQuadrature("quad")
        self.xe = jnp.asarray(self.grid.nodes[self.grid.elems])
        self._build_faces()
        self._build_pattern()

    # -- topology ----------------------------------------------------------
    def _eid(self, i, j):
        return i + self.nx * j

    def _build_faces(self):
        nx, ny = self.nx, self.ny
        i, j = np.meshgrid(np.arange(nx - 1), np.arange(ny), indexing="ij")
        self.vf_minus = self._eid(i, j).ravel()
        self.vf_plus = self._eid(i + 1, j).ravel()
        i, j = np.meshgrid(np.arange(nx), np.arange(ny - 1), indexing="ij")
        self.hf_minus = self._eid(i, j).ravel()
        self.hf_plus = self._eid(i, j + 1).ravel()
        # boundary faces per side: (element ids, face side)
        jj = np.arange(ny)
        ii = np.arange(nx)
        self.bf = {
            "x0": self._eid(np.zeros_like(jj), jj),
            "x1": self._eid(np.full_like(jj, nx - 1), jj),
            "y0": self._eid(ii, np.zeros_like(ii)),
            "y1": self._eid(ii, np.full_like(ii, ny - 1)),
        }

    def dof_tuples(self) -> np.ndarray:
        return (4 * np.arange(self.grid.n_elems)[:, None] + np.arange(4)).astype(
            np.int64
        )

    def _build_pattern(self):
        d = self.dof_tuples()
        rows = [np.repeat(d, 4, 1).ravel()]
        cols = [np.tile(d, (1, 4)).ravel()]
        for em, ep in ((self.vf_minus, self.vf_plus),
                       (self.hf_minus, self.hf_plus)):
            both = np.concatenate([d[em], d[ep]], axis=1)  # (nf, 8)
            rows.append(np.repeat(both, 8, 1).ravel())
            cols.append(np.tile(both, (1, 8)).ravel())
        self.pattern = EllPattern.from_coo(
            np.concatenate(rows), np.concatenate(cols), self.n_dofs
        )
        self._n_vol_coo = d.shape[0] * 16

    def adjacency(self) -> sps.csr_matrix:
        p = self.pattern
        return sps.csr_matrix(
            (np.ones(p.rows_csr.size), (p.rows_csr, p.cols_csr)),
            shape=(self.n_dofs, self.n_dofs),
        )

    @cached_property
    def dirichlet_mask(self) -> jnp.ndarray:
        return jnp.zeros((self.n_dofs,), bool)  # weak BCs

    @cached_property
    def dirichlet_values(self) -> jnp.ndarray:
        return jnp.zeros((self.n_dofs,))

    @cached_property
    def elem_centers(self) -> jnp.ndarray:
        return jnp.asarray(self.grid.elem_centroids())

    def node_coords_dg(self) -> np.ndarray:
        """(n_dofs, 2) coordinates of each DG dof (element corner nodes)."""
        return self.grid.nodes[self.grid.elems].reshape(-1, 2)

    # -- face kernels ------------------------------------------------------
    def _face_points(self, family: str):
        """Physical quad points (nf, q, 2) for a face family."""
        if family == "v":
            xf = self.lo[0] + (np.arange(1, self.nx)) * self.hx
            yf = self.lo[1] + np.arange(self.ny) * self.hy
            X, Y = np.meshgrid(xf, yf, indexing="ij")
            pts = np.stack(
                [np.repeat(X.ravel()[:, None], 2, 1),
                 Y.ravel()[:, None] + _QP[None, :] * self.hy], -1)
        else:
            xf = self.lo[0] + np.arange(self.nx) * self.hx
            yf = self.lo[1] + np.arange(1, self.ny) * self.hy
            X, Y = np.meshgrid(xf, yf, indexing="ij")
            pts = np.stack(
                [X.ravel()[:, None] + _QP[None, :] * self.hx,
                 np.repeat(Y.ravel()[:, None], 2, 1)], -1)
        return jnp.asarray(pts)

    def _boundary_points(self, side: str):
        if side in ("x0", "x1"):
            x = self.lo[0] + (0.0 if side == "x0" else self.nx * self.hx)
            y0 = self.lo[1] + np.arange(self.ny) * self.hy
            pts = np.stack(
                [np.full((self.ny, 2), x), y0[:, None] + _QP[None, :] * self.hy],
                -1)
        else:
            y = self.lo[1] + (0.0 if side == "y0" else self.ny * self.hy)
            x0 = self.lo[0] + np.arange(self.nx) * self.hx
            pts = np.stack(
                [x0[:, None] + _QP[None, :] * self.hx, np.full((self.nx, 2), y)],
                -1)
        return jnp.asarray(pts)

    def _interior_face_blocks(self, family: str, alpha_c: jnp.ndarray):
        """(nf, 8, 8) SIPG face blocks for one family."""
        p = self.problem
        if family == "v":
            em, ep = self.vf_minus, self.vf_plus
            Tm, Gm = _trace("x1", _QP)
            Tp, Gp = _trace("x0", _QP)
            h_perp, area, normal = self.hx, self.hy, jnp.array([1.0, 0.0])
        else:
            em, ep = self.hf_minus, self.hf_plus
            Tm, Gm = _trace("y1", _QP)
            Tp, Gp = _trace("y0", _QP)
            h_perp, area, normal = self.hy, self.hx, jnp.array([0.0, 1.0])
        # fluxes use the FACE normal (minus -> plus); _trace returns the
        # element-outward derivative, which on the plus side is the negative
        Gp = -Gp
        nf = em.shape[0]
        w = jnp.asarray(_QW) * area  # (q,)
        Tm, Gm, Tp, Gp = map(jnp.asarray, (Tm, Gm / h_perp, Tp, Gp / h_perp))
        dm = alpha_c[em][:, None]  # (nf, 1) delta_-
        dp = alpha_c[ep][:, None]
        om = dp / (dm + dp)
        op = dm / (dm + dp)
        gamma = self.sigma * (2 * dm * dp / (dm + dp)) / h_perp  # (nf, 1)

        # 8-wide trace/flux/jump arrays: (nf, q, 8)
        z = jnp.zeros((nf, 2, 4))
        J = jnp.concatenate(
            [jnp.broadcast_to(Tm, (nf, 2, 4)), -jnp.broadcast_to(Tp, (nf, 2, 4))],
            axis=2)
        F = jnp.concatenate(
            [(om * dm)[:, :, None] * Gm[None], (op * dp)[:, :, None] * Gp[None]],
            axis=2)
        pts = self._face_points(family)  # (nf, q, 2)
        if p.b is not None:
            bn = jnp.einsum("fqd,d->fq", p.b(pts), normal)
        else:
            bn = jnp.zeros((nf, 2))
        up = jnp.where(
            bn[:, :, None] >= 0,
            jnp.concatenate([jnp.broadcast_to(Tm, (nf, 2, 4)), z], axis=2),
            jnp.concatenate([z, jnp.broadcast_to(Tp, (nf, 2, 4))], axis=2),
        )
        K = (
            -jnp.einsum("q,fqb,fqa->fab", w, F, J)
            - jnp.einsum("q,fqa,fqb->fab", w, F, J)
            + gamma[:, :, None] * jnp.einsum("q,fqa,fqb->fab", w, J, J)
            + jnp.einsum("fq,q,fqb,fqa->fab", bn, w, up, J)
        )
        return K

    def _boundary_blocks(self, side: str, alpha_c: jnp.ndarray):
        """(nb, 4, 4) blocks + (nb, 4) rhs for one boundary side."""
        p = self.problem
        eb = self.bf[side]
        T, G = _trace(side, _QP)
        if side in ("x0", "x1"):
            h_perp, area = self.hx, self.hy
            normal = jnp.array([-1.0, 0.0]) if side == "x0" else jnp.array([1.0, 0.0])
        else:
            h_perp, area = self.hy, self.hx
            normal = jnp.array([0.0, -1.0]) if side == "y0" else jnp.array([0.0, 1.0])
        nb = eb.shape[0]
        w = jnp.asarray(_QW) * area
        T = jnp.asarray(T)
        G = jnp.asarray(G / h_perp)
        d = alpha_c[eb][:, None]  # (nb, 1)
        gamma = self.sigma * d / h_perp
        pts = self._boundary_points(side)  # (nb, q, 2)
        is_dir = p.is_dirichlet(pts)  # (nb, q) bool
        gq = p.g(pts)
        if p.b is not None:
            bn = jnp.einsum("fqd,d->fq", p.b(pts), normal)
        else:
            bn = jnp.zeros((nb, 2))
        bn_pos = jnp.maximum(bn, 0.0)
        bn_neg = jnp.minimum(bn, 0.0)

        dirf = is_dir.astype(gq.dtype)
        K = (
            -jnp.einsum("fq,q,qb,qa->fab", dirf * d, w, G, T)
            - jnp.einsum("fq,q,qa,qb->fab", dirf * d, w, G, T)
            + jnp.einsum("fq,q,qa,qb->fab", dirf * gamma, w, T, T)
            + jnp.einsum("fq,q,qb,qa->fab", bn_pos, w, T, T)
        )
        rhs = (
            -jnp.einsum("fq,q,qa->fa", dirf * d * gq, w, G)
            + jnp.einsum("fq,q,qa->fa", dirf * gamma * gq, w, T)
            - jnp.einsum("fq,q,qa->fa", dirf * bn_neg * gq, w, T)
        )
        return K, rhs

    # -- assembly ----------------------------------------------------------
    def _alpha_centers(self) -> jnp.ndarray:
        return self.problem.alpha(self.elem_centers)

    def assemble_parts(self, problem: Problem | None = None):
        """Returns (Ke_elem (n_e,4,4) volume+boundary blocks,
        Kv (nfv,8,8), Kh (nfh,8,8) interior face blocks, b (n_dofs,))."""
        p = problem or self.problem
        saved = self.problem
        self.problem = p
        try:
            alpha_c = self._alpha_centers()
            Ke, fe = assemble_convection_diffusion(
                self.quad, self.xe, p.alpha, p.b, p.c, p.f,
                convection_divergence_form=True,
            )
            b = jnp.zeros(self.n_dofs, Ke.dtype)
            b = b.at[jnp.asarray(self.dof_tuples().reshape(-1))].add(fe.reshape(-1))
            for side in ("x0", "x1", "y0", "y1"):
                Kb, rb = self._boundary_blocks(side, alpha_c)
                eb = self.bf[side]
                Ke = Ke.at[jnp.asarray(eb)].add(Kb)
                b = b.at[jnp.asarray(self.dof_tuples()[eb].reshape(-1))].add(
                    rb.reshape(-1)
                )
            Kv = self._interior_face_blocks("v", alpha_c)
            Kh = self._interior_face_blocks("h", alpha_c)
        finally:
            self.problem = saved
        return Ke, Kv, Kh, b

    def assemble(self, problem: Problem | None = None):
        Ke, Kv, Kh, b = self.assemble_parts(problem)
        coo = jnp.concatenate(
            [Ke.reshape(-1), Kv.reshape(-1), Kh.reshape(-1)]
        )
        A = self.pattern.assemble(coo)
        return A, b

    def constrained_system(self, problem=None):
        """Weak BCs: nothing to eliminate; g = 0 (interface parity)."""
        A, b = self.assemble(problem)
        return A, b, jnp.zeros_like(b)

    def element_matrices(self, problem=None):
        # volume-only (used by generic code paths); prefer neumann_stamps
        p = problem or self.problem
        return assemble_convection_diffusion(
            self.quad, self.xe, p.alpha, p.b, p.c, p.f,
            convection_divergence_form=True,
        )

    def neumann_stamps(self, problem=None):
        p = problem or self.problem
        if getattr(p, "symmetric", True) is False:
            p = p.symmetrized()
        Ke, Kv, Kh, _ = self.assemble_parts(p)
        d = self.dof_tuples()
        groups = [(d, Ke)]
        for em, ep, K in (
            (self.vf_minus, self.vf_plus, Kv),
            (self.hf_minus, self.hf_plus, Kh),
        ):
            both = np.concatenate([d[em], d[ep]], axis=1)
            groups.append((both, K))
        return groups


# ===========================================================================
# Unstructured simplex DG (P1 SIPG on triangle meshes)
# ===========================================================================

def _match_faces(elems: np.ndarray, elem_type: str):
    """Enumerate mesh faces from ELEM_FACES (general unstructured path,
    replacing the structured i/j face families).

    Returns (interior, boundary):
      interior: (elem_m, lf_m, elem_p, lf_p) int arrays, one row set per
                shared face (minus = lower element id);
      boundary: (elem, lf) for faces owned by exactly one element.
    """
    faces = ELEM_FACES[elem_type]
    n_e = elems.shape[0]
    n_lf = len(faces)
    all_faces = np.stack(
        [np.sort(elems[:, list(f)], axis=1) for f in faces], axis=1
    ).reshape(n_e * n_lf, -1)  # row order: elem-major, local-face-minor
    owner_elem = np.repeat(np.arange(n_e), n_lf)
    owner_lf = np.tile(np.arange(n_lf), n_e)
    uniq, inverse, counts = np.unique(
        all_faces, axis=0, return_inverse=True, return_counts=True
    )
    order = np.argsort(inverse, kind="stable")
    starts = np.zeros(uniq.shape[0], dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    if counts.max() > 2:
        raise ValueError("non-manifold mesh: a face shared by >2 elements")
    two = counts == 2
    first = order[starts[two]]
    second = order[starts[two] + 1]
    one = order[starts[~two]]
    interior = (owner_elem[first], owner_lf[first],
                owner_elem[second], owner_lf[second])
    boundary = (owner_elem[one], owner_lf[one])
    return interior, boundary


def _barycentric(xe: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """P1 trace values: barycentric coordinates of physical points.

    xe: (nf, 3, 2) triangle vertices; pts: (nf, q, 2).
    Returns (nf, q, 3)."""
    v1 = xe[:, 1] - xe[:, 0]  # (nf, 2)
    v2 = xe[:, 2] - xe[:, 0]
    det = v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0]  # (nf,)
    r = pts - xe[:, None, 0]  # (nf, q, 2)
    l1 = (r[..., 0] * v2[:, None, 1] - r[..., 1] * v2[:, None, 0]) / det[:, None]
    l2 = (v1[:, None, 0] * r[..., 1] - v1[:, None, 1] * r[..., 0]) / det[:, None]
    return jnp.stack([1.0 - l1 - l2, l1, l2], axis=-1)


@dataclass
class SimplexDGDiscretization:
    """P1 SIPG convection-diffusion on unstructured triangle meshes.

    The unstructured counterpart of :class:`DGDiscretization` (reference:
    examples/convectiondiffusiondg.cc:36-60 runs DG on a UGGrid, i.e. an
    unstructured-capable grid): faces are enumerated from ``ELEM_FACES``
    instead of structured i/j families, and all per-face geometry (normals,
    lengths, traces, constant P1 gradients) is batched over the full face
    set at once.  Penalty length scale: ``h_perp = min(vol-, vol+)/|F|``
    (PDELab's ConvectionDiffusionDG face-measure convention; equals the
    perpendicular cell width on structured quads)."""

    grid: Grid
    problem: Problem
    sigma: float = 4.0
    n_comp: int = 1
    definite: bool = False  # see DGDiscretization.definite

    def __post_init__(self):
        if self.grid.elem_type != "tri":
            raise NotImplementedError(
                "SimplexDGDiscretization supports triangle meshes"
            )
        g = self.grid
        self.n_dofs = 3 * g.n_elems
        self.quad = ElementQuadrature("tri")
        self.xe = jnp.asarray(g.nodes[g.elems])
        self._build_faces()
        self._build_pattern()

    # -- host topology/geometry ---------------------------------------------
    def _build_faces(self):
        g = self.grid
        (em, lm, ep, lp), (eb, lb) = _match_faces(g.elems, "tri")
        self.f_elems = (em.astype(np.int64), lm.astype(np.int64),
                        ep.astype(np.int64), lp.astype(np.int64))
        self.b_elems = (eb.astype(np.int64), lb.astype(np.int64))

        faces = ELEM_FACES["tri"]
        X = g.nodes[g.elems]  # (n_e, 3, 2)
        v1 = X[:, 1] - X[:, 0]
        v2 = X[:, 2] - X[:, 0]
        self.vol = 0.5 * np.abs(v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0])
        cent = X.mean(axis=1)

        def face_geom(e, lf):
            """(pa, pb, normal (outward from e), length) for faces (e, lf)."""
            fa = np.array([faces[j][0] for j in lf])
            fb = np.array([faces[j][1] for j in lf])
            ga = g.elems[e, fa]
            gb = g.elems[e, fb]
            pa, pb = g.nodes[ga], g.nodes[gb]
            t = pb - pa
            L = np.linalg.norm(t, axis=1)
            nrm = np.stack([t[:, 1], -t[:, 0]], axis=1) / L[:, None]
            mid = 0.5 * (pa + pb)
            flip = np.einsum("fd,fd->f", nrm, mid - cent[e]) < 0
            nrm[flip] *= -1.0
            return pa, pb, nrm, L

        self.f_geom = face_geom(self.f_elems[0], self.f_elems[1])
        self.b_geom = face_geom(self.b_elems[0], self.b_elems[1])

    def dof_tuples(self) -> np.ndarray:
        return (3 * np.arange(self.grid.n_elems)[:, None] + np.arange(3)).astype(
            np.int64
        )

    def _face_dofs(self) -> np.ndarray:
        d = self.dof_tuples()
        em, _, ep, _ = self.f_elems
        return np.concatenate([d[em], d[ep]], axis=1)  # (nf, 6)

    def _build_pattern(self):
        d = self.dof_tuples()
        rows = [np.repeat(d, 3, 1).ravel()]
        cols = [np.tile(d, (1, 3)).ravel()]
        both = self._face_dofs()
        rows.append(np.repeat(both, 6, 1).ravel())
        cols.append(np.tile(both, (1, 6)).ravel())
        self.pattern = EllPattern.from_coo(
            np.concatenate(rows), np.concatenate(cols), self.n_dofs
        )

    def adjacency(self) -> sps.csr_matrix:
        p = self.pattern
        return sps.csr_matrix(
            (np.ones(p.rows_csr.size), (p.rows_csr, p.cols_csr)),
            shape=(self.n_dofs, self.n_dofs),
        )

    @cached_property
    def dirichlet_mask(self) -> jnp.ndarray:
        return jnp.zeros((self.n_dofs,), bool)  # weak BCs

    @cached_property
    def dirichlet_values(self) -> jnp.ndarray:
        return jnp.zeros((self.n_dofs,))

    @cached_property
    def elem_centers(self) -> jnp.ndarray:
        return jnp.asarray(self.grid.elem_centroids())

    def node_coords_dg(self) -> np.ndarray:
        return self.grid.nodes[self.grid.elems].reshape(-1, 2)

    # -- constant P1 gradients ------------------------------------------------
    @cached_property
    def _grads(self) -> jnp.ndarray:
        """(n_e, 3, 2) constant physical gradients of the P1 basis."""
        X = self.xe
        v1 = X[:, 1] - X[:, 0]
        v2 = X[:, 2] - X[:, 0]
        det = (v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0])[:, None]
        g1 = jnp.stack([v2[:, 1], -v2[:, 0]], axis=1) / det
        g2 = jnp.stack([-v1[:, 1], v1[:, 0]], axis=1) / det
        return jnp.stack([-g1 - g2, g1, g2], axis=1)

    # -- face kernels ----------------------------------------------------------
    def _interior_face_blocks(self, p: Problem, alpha_c: jnp.ndarray):
        """(nf, 6, 6) SIPG blocks over all interior faces at once."""
        em, _, ep, _ = self.f_elems
        pa, pb, nrm, L = self.f_geom
        nf = em.shape[0]
        pa, nrm, L = jnp.asarray(pa), jnp.asarray(nrm), jnp.asarray(L)
        t = jnp.asarray(pb) - pa
        pts = pa[:, None, :] + jnp.asarray(_QP)[None, :, None] * t[:, None, :]
        w = jnp.asarray(_QW)[None, :] * L[:, None]  # (nf, q)

        Tm = _barycentric(self.xe[em], pts)  # (nf, q, 3)
        Tp = _barycentric(self.xe[ep], pts)
        # face normal points OUT of the minus element (m -> p) by
        # construction in _build_faces; grad.n on both sides uses it
        Gm = jnp.einsum("fid,fd->fi", self._grads[em], nrm)  # (nf, 3)
        Gp = jnp.einsum("fid,fd->fi", self._grads[ep], nrm)

        dm = alpha_c[em][:, None]
        dp = alpha_c[ep][:, None]
        om = dp / (dm + dp)
        op = dm / (dm + dp)
        vol = jnp.asarray(self.vol)
        h_perp = jnp.minimum(vol[em], vol[ep]) / L
        gamma = self.sigma * (2 * dm * dp / (dm + dp))[:, :, None] / h_perp[:, None, None]

        J = jnp.concatenate([Tm, -Tp], axis=2)  # (nf, q, 6)
        F = jnp.concatenate(
            [
                jnp.broadcast_to((om * dm)[:, :, None] * Gm[:, None, :], Tm.shape),
                jnp.broadcast_to((op * dp)[:, :, None] * Gp[:, None, :], Tp.shape),
            ],
            axis=2,
        )
        if p.b is not None:
            bn = jnp.einsum("fqd,fd->fq", p.b(pts), nrm)
        else:
            bn = jnp.zeros(pts.shape[:2])
        z = jnp.zeros_like(Tm)
        up = jnp.where(
            bn[:, :, None] >= 0,
            jnp.concatenate([Tm, z], axis=2),
            jnp.concatenate([z, Tp], axis=2),
        )
        K = (
            -jnp.einsum("fq,fqb,fqa->fab", w, F, J)
            - jnp.einsum("fq,fqa,fqb->fab", w, F, J)
            + gamma[:, 0, 0, None, None]
            * jnp.einsum("fq,fqa,fqb->fab", w, J, J)
            + jnp.einsum("fq,fq,fqb,fqa->fab", bn, w, up, J)
        )
        return K

    def _boundary_blocks(self, p: Problem, alpha_c: jnp.ndarray):
        """(nb, 3, 3) Nitsche/outflow blocks + (nb, 3) rhs."""
        eb, _ = self.b_elems
        pa, pb, nrm, L = self.b_geom
        pa, nrm, L = jnp.asarray(pa), jnp.asarray(nrm), jnp.asarray(L)
        t = jnp.asarray(pb) - pa
        pts = pa[:, None, :] + jnp.asarray(_QP)[None, :, None] * t[:, None, :]
        w = jnp.asarray(_QW)[None, :] * L[:, None]

        T = _barycentric(self.xe[eb], pts)  # (nb, q, 3)
        G = jnp.einsum("fid,fd->fi", self._grads[eb], nrm)  # (nb, 3) outward
        d = alpha_c[eb][:, None]  # (nb, 1)
        vol = jnp.asarray(self.vol)
        h_perp = vol[eb] / L
        gamma = self.sigma * d / h_perp[:, None]
        is_dir = p.is_dirichlet(pts)
        gq = p.g(pts)
        if p.b is not None:
            bn = jnp.einsum("fqd,fd->fq", p.b(pts), nrm)
        else:
            bn = jnp.zeros(pts.shape[:2])
        bn_pos = jnp.maximum(bn, 0.0)
        bn_neg = jnp.minimum(bn, 0.0)
        dirf = is_dir.astype(gq.dtype)

        K = (
            -jnp.einsum("fq,fq,fb,fqa->fab", dirf * d, w, G, T)
            - jnp.einsum("fq,fq,fa,fqb->fab", dirf * d, w, G, T)
            + jnp.einsum("fq,fq,fqa,fqb->fab", dirf * gamma, w, T, T)
            + jnp.einsum("fq,fq,fqb,fqa->fab", bn_pos, w, T, T)
        )
        rhs = (
            -jnp.einsum("fq,fq,fa->fa", dirf * d * gq, w, G)
            + jnp.einsum("fq,fq,fqa->fa", dirf * gamma * gq, w, T)
            - jnp.einsum("fq,fq,fqa->fa", dirf * bn_neg * gq, w, T)
        )
        return K, rhs

    # -- assembly ---------------------------------------------------------------
    def assemble_parts(self, problem: Problem | None = None):
        p = problem or self.problem
        alpha_c = p.alpha(self.elem_centers)
        Ke, fe = assemble_convection_diffusion(
            self.quad, self.xe, p.alpha, p.b, p.c, p.f,
            convection_divergence_form=True,
        )
        b = jnp.zeros(self.n_dofs, Ke.dtype)
        b = b.at[jnp.asarray(self.dof_tuples().reshape(-1))].add(fe.reshape(-1))
        Kb, rb = self._boundary_blocks(p, alpha_c)
        eb, _ = self.b_elems
        Ke = Ke.at[jnp.asarray(eb)].add(Kb)
        b = b.at[jnp.asarray(self.dof_tuples()[eb].reshape(-1))].add(rb.reshape(-1))
        Kf = self._interior_face_blocks(p, alpha_c)
        return Ke, Kf, b

    def assemble(self, problem: Problem | None = None):
        Ke, Kf, b = self.assemble_parts(problem)
        coo = jnp.concatenate([Ke.reshape(-1), Kf.reshape(-1)])
        A = self.pattern.assemble(coo)
        return A, b

    def constrained_system(self, problem=None):
        A, b = self.assemble(problem)
        return A, b, jnp.zeros_like(b)

    def neumann_stamps(self, problem=None):
        p = problem or self.problem
        if getattr(p, "symmetric", True) is False:
            p = p.symmetrized()
        Ke, Kf, _ = self.assemble_parts(p)
        return [(self.dof_tuples(), Ke), (self._face_dofs(), Kf)]
