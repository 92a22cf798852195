"""Batched FEM assembly in JAX.

Replaces PDELab's GridOperator + local operators (reference:
ConvectionDiffusionFEM et al., driven via examples/generic_ddm_problem.hh).
Instead of per-element loops, *all* element stiffness matrices are computed as
one batched device op, then scattered into
the global ELL matrix through the precomputed COO->slot map
(core/sparse.py:EllPattern).

Scalar convection-diffusion form (reference: ConvectionDiffusionFEM):

    a(u,v) = ∫ α ∇u·∇v + (b·∇u) v + c u v ,   rhs ∫ f v

with per-quadrature-point coefficients supplied by a :class:`Problem`
(fem/problems.py), the analogue of the reference's Lua-scripted coefficient
classes (examples/poisson_problems.hh, convection_diffusion_problems.hh).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .grids import Grid


def _at(fn, x):
    """Coefficient ``fn`` at points ``x``; None stays None."""
    return None if fn is None else fn(x)


# -- reference-element quadrature + shape functions --------------------------

_GPT = 1.0 / np.sqrt(3.0)


def _quad_rule(elem_type: str):
    """Returns (points (q, d), weights (q,)) on the reference element."""
    if elem_type == "tri":
        # degree-2, 3 points, area 1/2
        pts = np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]])
        w = np.full(3, 1 / 6)
    elif elem_type == "tri2":
        # degree-4 (Dunavant 6-point) for P2 stiffness/mass terms
        a1, a2 = 0.445948490915965, 0.091576213509771
        w1, w2 = 0.223381589678011, 0.109951743655322
        pts = np.array([
            [a1, a1], [1 - 2 * a1, a1], [a1, 1 - 2 * a1],
            [a2, a2], [1 - 2 * a2, a2], [a2, 1 - 2 * a2],
        ])
        w = np.array([w1, w1, w1, w2, w2, w2]) * 0.5
    elif elem_type == "quad2":
        # 3x3 Gauss on [0,1]^2
        g = np.array([0.5 - 0.5 * np.sqrt(3 / 5), 0.5, 0.5 + 0.5 * np.sqrt(3 / 5)])
        wg = np.array([5 / 18, 8 / 18, 5 / 18])
        X, Y = np.meshgrid(g, g, indexing="ij")
        pts = np.stack([X.ravel(), Y.ravel()], -1)
        w = np.outer(wg, wg).ravel()
    elif elem_type == "tet":
        a, b = 0.5854101966249685, 0.1381966011250105
        pts = np.array(
            [[b, b, b], [a, b, b], [b, a, b], [b, b, a]]
        )
        w = np.full(4, 1 / 24)
    elif elem_type in ("quad", "hex"):
        d = 2 if elem_type == "quad" else 3
        g1 = np.array([0.5 - 0.5 * _GPT, 0.5 + 0.5 * _GPT])
        grids = np.meshgrid(*([g1] * d), indexing="ij")
        pts = np.stack([g.ravel() for g in grids], axis=-1)
        w = np.full(2**d, 0.5**d)
    else:
        raise ValueError(elem_type)
    return pts, w


def _shape_funs(elem_type: str, pts: np.ndarray):
    """phi (q, nd) and dphi (q, nd, d) at reference points."""
    if elem_type == "tri":
        x, y = pts[:, 0], pts[:, 1]
        phi = np.stack([1 - x - y, x, y], axis=-1)
        dphi = np.broadcast_to(
            np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]]), (pts.shape[0], 3, 2)
        ).copy()
    elif elem_type == "tet":
        x, y, z = pts.T
        phi = np.stack([1 - x - y - z, x, y, z], axis=-1)
        dphi = np.broadcast_to(
            np.array(
                [[-1.0, -1.0, -1.0], [1, 0, 0], [0, 1, 0], [0, 0, 1]]
            ),
            (pts.shape[0], 4, 3),
        ).copy()
    elif elem_type == "tri2":
        # P2 triangle: vertices (v0,v1,v2) then edge midpoints (e01,e12,e20)
        x, y = pts[:, 0], pts[:, 1]
        L = [1 - x - y, x, y]
        dL = [np.array([-1.0, -1.0]), np.array([1.0, 0.0]), np.array([0.0, 1.0])]
        q = pts.shape[0]
        phi = np.zeros((q, 6))
        dphi = np.zeros((q, 6, 2))
        for i in range(3):
            phi[:, i] = L[i] * (2 * L[i] - 1)
            dphi[:, i] = (4 * L[i] - 1)[:, None] * dL[i][None, :]
        edges = [(0, 1), (1, 2), (2, 0)]
        for k, (a, b) in enumerate(edges):
            phi[:, 3 + k] = 4 * L[a] * L[b]
            dphi[:, 3 + k] = 4 * (
                L[a][:, None] * dL[b][None, :] + L[b][:, None] * dL[a][None, :]
            )
    elif elem_type == "quad2":
        # Q2, tensor-product lexicographic: 9 nodes at t in {0, 1/2, 1},
        # x fastest
        def n1d(t):
            return np.stack(
                [(2 * t - 1) * (t - 1), 4 * t * (1 - t), t * (2 * t - 1)], -1
            )

        def dn1d(t):
            return np.stack([4 * t - 3, 4 - 8 * t, 4 * t - 1], -1)

        nx, ny = n1d(pts[:, 0]), n1d(pts[:, 1])
        dx, dy = dn1d(pts[:, 0]), dn1d(pts[:, 1])
        q = pts.shape[0]
        phi = np.zeros((q, 9))
        dphi = np.zeros((q, 9, 2))
        for j in range(3):
            for i in range(3):
                k = j * 3 + i
                phi[:, k] = nx[:, i] * ny[:, j]
                dphi[:, k, 0] = dx[:, i] * ny[:, j]
                dphi[:, k, 1] = nx[:, i] * dy[:, j]
    elif elem_type in ("quad", "hex"):
        d = 2 if elem_type == "quad" else 3
        nd = 2**d
        q = pts.shape[0]
        phi = np.ones((q, nd))
        dphi = np.ones((q, nd, d))
        for i in range(nd):
            for dd in range(d):
                bit = (i >> dd) & 1
                f = pts[:, dd] if bit else 1 - pts[:, dd]
                df = 1.0 if bit else -1.0
                phi[:, i] *= f
                for other in range(d):
                    if other == dd:
                        dphi[:, i, other] *= df
                    else:
                        dphi[:, i, other] *= f
    else:
        raise ValueError(elem_type)
    return phi, dphi


class ElementQuadrature:
    """Static (host-precomputed) reference-element data for an element type."""

    def __init__(self, elem_type: str):
        self.elem_type = elem_type
        pts, w = _quad_rule(elem_type)
        phi, dphi = _shape_funs(elem_type, pts)
        self.ref_pts = jnp.asarray(pts)  # (q, d)
        self.weights = jnp.asarray(w)  # (q,)
        self.phi = jnp.asarray(phi)  # (q, nd)
        self.dphi = jnp.asarray(dphi)  # (q, nd, d)


def _det_inv_small(J: jnp.ndarray):
    """Closed-form det + inverse for batched 2x2 / 3x3 Jacobians.

    (Adjugate formulas are cheaper than a batched LU for tiny matrices.)
    """
    d = J.shape[-1]
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, e = J[..., 1, 0], J[..., 1, 1]
        det = a * e - b * c
        inv = jnp.stack(
            [jnp.stack([e, -b], -1), jnp.stack([-c, a], -1)], -2
        ) / det[..., None, None]
        return det, inv
    if d == 3:
        m = J
        c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
        c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
        c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
        det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
        c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
        c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
        c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
        c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
        c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
        c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        inv = jnp.stack(
            [
                jnp.stack([c00, c10, c20], -1),
                jnp.stack([c01, c11, c21], -1),
                jnp.stack([c02, c12, c22], -1),
            ],
            -2,
        ) / det[..., None, None]
        return det, inv
    raise ValueError(f"unsupported dimension {d}")


def element_geometry(quad: ElementQuadrature, xe: jnp.ndarray):
    """Per-quadrature-point geometry for a batch of elements.

    xe: (n_e, nd, d) vertex coordinates.
    Returns (xq (n_e, q, d) physical points, grads (n_e, q, nd, d) physical
    shape gradients, jxw (n_e, q) |det J| * weight).
    """
    # physical points: x(q) = sum_i phi_i(q) x_i
    xq = jnp.einsum("qi,eid->eqd", quad.phi, xe)
    # Jacobian dx/dxi: (n_e, q, d, d)
    J = jnp.einsum("qid,eig->eqgd", quad.dphi, xe)
    detJ, Jinv = _det_inv_small(J)
    # physical gradient: dphi_ref @ J^{-1}
    grads = jnp.einsum("qid,eqdg->eqig", quad.dphi, Jinv)
    jxw = jnp.abs(detJ) * quad.weights[None, :]
    return xq, grads, jxw


def _elem_chunk(quad: ElementQuadrature, xe, factor: int = 1) -> int | None:
    """Element-batch chunk size, or None to assemble in one shot.

    The per-quadrature-point temporaries scale as n_e * q * nd * d (times
    d*d more for elasticity): at 3-D bench scale (157k hexes) the one-shot
    einsums need 22.7 GB of temporaries.  Chunk the
    element batch so each slab's temporaries stay bounded; 2-D bench-scale
    batches stay far below the threshold and keep the one-shot path.
    ``DDM_ASSEMBLY_CHUNK`` overrides (0 disables chunking)."""
    import os

    env = os.environ.get("DDM_ASSEMBLY_CHUNK")
    if env is not None:
        c = int(env)
        return None if c <= 0 or c >= xe.shape[0] else c
    n_e, nd, d = xe.shape
    q = quad.phi.shape[0]
    budget = 4 << 20  # grads elements per slab (~32 MB f64)
    per = q * nd * d * factor
    if n_e * per <= 2 * budget:
        return None
    return max(1024, budget // per)


def _chunked_elements(body, args, chunk: int):
    """Run ``body`` (slab pytree -> pytree of (n_slab, ...) arrays) over the
    element batch in ``chunk``-sized slabs via ``lax.map`` (one compile,
    slab-sized temporaries).  ``args`` is a pytree of (n_e, ...) arrays
    (``None`` entries pass through to the body unchanged).  Padding repeats
    the last element — valid geometry, so no NaN/inf leaks — and is sliced
    off the outputs."""
    n_e = jax.tree_util.tree_leaves(args)[0].shape[0]
    k = -(-n_e // chunk)
    pad = k * chunk - n_e

    def prep(a):
        ap = jnp.concatenate([a, jnp.repeat(a[-1:], pad, axis=0)]) if pad else a
        return ap.reshape((k, chunk) + a.shape[1:])

    out = jax.lax.map(body, jax.tree_util.tree_map(prep, args))
    return jax.tree_util.tree_map(
        lambda a: a.reshape((k * chunk,) + a.shape[2:])[:n_e], out
    )


def assemble_convection_diffusion(
    quad: ElementQuadrature,
    xe: jnp.ndarray,
    alpha_fn,
    b_fn=None,
    c_fn=None,
    f_fn=None,
    convection_divergence_form: bool = False,
):
    """Batched element matrices/vectors for the convection-diffusion form.

    xe: (n_e, nd, d).  Coefficient callables map (..., d) -> scalar
    ((..., d) -> (..., d) for the convection field ``b_fn``).
    Returns (Ke (n_e, nd, nd), fe (n_e, nd)).

    convection_divergence_form: use -(u, b.grad v) instead of (b.grad u, v)
    — the integrated-by-parts form required for consistency with upwind DG
    face fluxes (assumes div b = 0, as PDELab's ConvectionDiffusionDG does).
    """
    chunk = _elem_chunk(quad, xe)
    if chunk is not None:
        # Coefficients are evaluated once on the full quadrature-point
        # batch; only the geometry/einsum stages are chunked (the
        # (n_e, q[, d]) coefficient arrays are small).
        xq = jnp.einsum("qi,eid->eqd", quad.phi, xe)
        coeffs = tuple(
            _at(fn, xq) for fn in (alpha_fn, b_fn, c_fn, f_fn)
        )
        return _chunked_elements(
            lambda s: _cd_terms(quad, s[0], *s[1:], convection_divergence_form),
            (xe,) + coeffs, chunk,
        )
    xq, grads, jxw = element_geometry(quad, xe)
    coeffs = tuple(
        _at(fn, xq) for fn in (alpha_fn, b_fn, c_fn, f_fn)
    )
    return _cd_terms(quad, xe, *coeffs, convection_divergence_form,
                     geom=(grads, jxw))


def _cd_terms(quad, xe, alpha, b, c, f, convection_divergence_form,
              geom=None):
    """Einsum stages of the convection-diffusion assembly, taking concrete
    per-quadrature-point coefficient VALUE arrays (None = term absent)."""
    grads, jxw = geom if geom is not None else element_geometry(quad, xe)[1:]
    Ke = jnp.einsum("eq,eqig,eqjg->eij", jxw * alpha, grads, grads)
    if b is not None:
        if convection_divergence_form:
            # - u_j (b . grad v_i)
            Ke = Ke - jnp.einsum(
                "eq,eqd,eqid,qj->eij", jxw, b, grads, quad.phi
            )
        else:
            # + (b . grad u_j) v_i
            Ke = Ke + jnp.einsum("eq,qi,eqd,eqjd->eij", jxw, quad.phi, b, grads)
    if c is not None:
        Ke = Ke + jnp.einsum("eq,qi,qj->eij", jxw * c, quad.phi, quad.phi)
    if f is not None:
        fe = jnp.einsum("eq,qi->ei", jxw * f, quad.phi)
    else:
        fe = jnp.zeros(Ke.shape[:2], Ke.dtype)
    return Ke, fe


def assemble_linear_elasticity(
    quad: ElementQuadrature,
    xe: jnp.ndarray,
    lame_lambda_fn,
    lame_mu_fn,
    f_fn=None,
):
    """Batched element matrices for linear elasticity (vector P1/Q1).

    Form: ∫ 2 μ ε(u):ε(v) + λ (div u)(div v),  rhs ∫ f·v
    (reference: dune-pdelab LinearElasticity local operator, used by
    examples/linearelasticity.cc).

    DOF ordering within the element: node-major, component-minor, i.e.
    dof (i, c) -> i * d + c.  Returns (Ke (n_e, nd*d, nd*d), fe (n_e, nd*d)).
    """
    # the eps/div einsum temporaries are (e, q, i, j, c, k) — nd*d times
    # the scalar assembler's grads stream
    chunk = _elem_chunk(quad, xe, factor=xe.shape[1] * xe.shape[2])
    if chunk is not None:
        # full-batch coefficient evaluation; chunk only the geometry/einsum
        # stages — see the scalar assembler
        xq = jnp.einsum("qi,eid->eqd", quad.phi, xe)
        lam = lame_lambda_fn(xq)
        mu = lame_mu_fn(xq)
        f = _at(f_fn, xq)
        return _chunked_elements(
            lambda s: _elasticity_terms(quad, *s),
            (xe, lam, mu, f), chunk,
        )
    xq, grads, jxw = element_geometry(quad, xe)
    lam = lame_lambda_fn(xq)  # (n_e, q)
    mu = lame_mu_fn(xq)
    f = _at(f_fn, xq)
    return _elasticity_terms(quad, xe, lam, mu, f, geom=(grads, jxw))


def _elasticity_terms(quad, xe, lam, mu, f, geom=None):
    """Einsum stages of the elasticity assembly on concrete coefficient
    value arrays (None f = zero load)."""
    grads, jxw = geom if geom is not None else element_geometry(quad, xe)[1:]
    n_e, q, nd, d = grads.shape

    # div(phi_ic) = grads[:,:,i,c]; eps(u_ic):eps(v_jk):
    # 0.5*(grad_c phi_i e_c + ...) contraction works out to
    #   0.5 * ( delta_ck (grad phi_i . grad phi_j) + dphi_i/dx_k dphi_j/dx_c )
    gg = jnp.einsum("eqig,eqjg->eqij", grads, grads)  # (e,q,i,j)
    # eps(u):eps(v) for u = phi_j e_c, v = phi_i e_k:
    #   0.5 * ( delta_ck gg_ij + dphi_j/dx_k * dphi_i/dx_c )
    eye = jnp.eye(d)
    eps_term = 0.5 * (
        jnp.einsum("ck,eqij->eqijck", eye, gg)
        + jnp.einsum("eqjk,eqic->eqijck", grads, grads)
    )
    div_term = jnp.einsum("eqjc,eqik->eqijck", grads, grads)
    Kfull = jnp.einsum("eq,eqijck->eijck", jxw * 2 * mu, eps_term) + jnp.einsum(
        "eq,eqijck->eijck", jxw * lam, div_term
    )
    # reorder (i, k; j, c) -> rows (i*d + k), cols (j*d + c)
    Ke = Kfull.transpose(0, 1, 4, 2, 3).reshape(n_e, nd * d, nd * d)
    if f is not None:
        fe = jnp.einsum("eq,qi,eqc->eic", jxw, quad.phi, f).reshape(n_e, nd * d)
    else:
        fe = jnp.zeros((n_e, nd * d), Ke.dtype)
    return Ke, fe


def element_coo_indices(elems: np.ndarray, n_comp: int = 1):
    """Host: (rows, cols) COO index arrays for element matrices.

    elems: (n_e, nd) node connectivity.  With ``n_comp`` > 1, dofs are blocked
    node-major/component-minor (matching assemble_linear_elasticity).
    Order matches ``Ke.reshape(-1)`` of an (n_e, nd*c, nd*c) batch.
    """
    n_e, nd = elems.shape
    if n_comp == 1:
        dofs = elems
    else:
        dofs = (elems[:, :, None] * n_comp + np.arange(n_comp)).reshape(n_e, nd * n_comp)
    nl = dofs.shape[1]
    rows = np.repeat(dofs, nl, axis=1).reshape(-1)
    cols = np.tile(dofs, (1, nl)).reshape(-1)
    return rows, cols
