"""FEM layer: assembly correctness against scipy reference solutions.

Validation strategy per SURVEY.md §7.2 M0: the assembled Poisson system on
structured/unstructured meshes must match a scipy sparse direct solve and
known analytic solutions.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla

from ddm_jax.core.sparse import EllPattern, eliminate_dirichlet
from ddm_jax.fem import structured_grid
from ddm_jax.fem.assemble import (
    ElementQuadrature,
    assemble_convection_diffusion,
    element_coo_indices,
)
from ddm_jax.fem import problems as prob


def build_poisson(grid, problem):
    quad = ElementQuadrature(grid.elem_type)
    xe = jnp.asarray(grid.nodes[grid.elems])
    Ke, fe = assemble_convection_diffusion(
        quad, xe, problem.alpha, problem.b, problem.c, problem.f
    )
    rows, cols = element_coo_indices(grid.elems)
    pat = EllPattern.from_coo(rows, cols, grid.n_nodes)
    A = pat.assemble(Ke.reshape(-1))
    b = jnp.zeros(grid.n_nodes).at[jnp.asarray(grid.elems.reshape(-1))].add(
        fe.reshape(-1)
    )
    return pat, A, b, quad


def constrain(pat, A, b, grid, problem):
    xs = jnp.asarray(grid.nodes)
    dmask = jnp.asarray(grid.boundary_nodes()) & problem.is_dirichlet(xs)
    gvec = jnp.where(dmask, problem.g(xs), 0.0)
    rhs = b - A.mv(gvec)
    rhs = jnp.where(dmask, 0.0, rhs)
    Ac = eliminate_dirichlet(A, dmask)
    return Ac, rhs, gvec, dmask


def test_q1_laplace_matches_scipy():
    grid = structured_grid((8, 8))
    problem = prob.simple()
    pat, A, b, _ = build_poisson(grid, problem)
    Ac, rhs, gvec, dmask = constrain(pat, A, b, grid, problem)

    Asp = pat.to_scipy(Ac).tocsr()
    x = spla.spsolve(Asp.tocsc(), np.asarray(rhs))
    u = x + np.asarray(gvec)

    # interior row of Q1 Laplacian on uniform square grid: 8/3 diag, known stencil
    h = 1.0 / 8
    n = grid.n_nodes
    center = np.argmin(np.abs(grid.nodes - 0.5).sum(axis=1))
    assert abs(Asp[center, center] - 8.0 / 3.0) < 1e-12

    # maximum of -Δu = 1 on unit square with u=0: u(0.5,0.5) ≈ 0.07367
    assert abs(u[center] - 0.0736713) < 2e-3


def test_q1_manufactured_solution_convergence():
    # -Δu = 2π² sin(πx) sin(πy), u = sin(πx)sin(πy)
    errs = []
    for nc in (8, 16):
        grid = structured_grid((nc, nc))
        problem = prob.Problem(
            f=lambda x: 2
            * np.pi**2
            * jnp.sin(np.pi * x[..., 0])
            * jnp.sin(np.pi * x[..., 1]),
        )
        pat, A, b, _ = build_poisson(grid, problem)
        Ac, rhs, gvec, dmask = constrain(pat, A, b, grid, problem)
        Asp = pat.to_scipy(Ac)
        u = spla.spsolve(Asp.tocsc(), np.asarray(rhs))
        exact = np.sin(np.pi * grid.nodes[:, 0]) * np.sin(np.pi * grid.nodes[:, 1])
        errs.append(np.abs(u - exact).max())
    # O(h²) convergence
    assert errs[0] / errs[1] > 3.0


def test_tri_mesh_assembly():
    # structured grid of triangles via unitsquare msh is tested elsewhere;
    # here: one reference triangle, exact P1 stiffness
    from ddm_jax.fem.grids import Grid

    nodes = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    elems = np.array([[0, 1, 2]])
    grid = Grid(nodes=nodes, elems=elems, elem_type="tri")
    quad = ElementQuadrature("tri")
    xe = jnp.asarray(nodes[elems])
    Ke, _ = assemble_convection_diffusion(quad, xe, lambda x: jnp.ones(x.shape[:-1]))
    expected = 0.5 * np.array(
        [[2.0, -1.0, -1.0], [-1.0, 1.0, 0.0], [-1.0, 0.0, 1.0]]
    )
    np.testing.assert_allclose(np.asarray(Ke[0]), expected, atol=1e-14)


def test_hex_laplace_positive_definite():
    grid = structured_grid((3, 3, 3))
    problem = prob.simple()
    pat, A, b, _ = build_poisson(grid, problem)
    Ac, rhs, gvec, dmask = constrain(pat, A, b, grid, problem)
    Asp = pat.to_scipy(Ac).toarray()
    np.testing.assert_allclose(Asp, Asp.T, atol=1e-13)
    w = np.linalg.eigvalsh(Asp)
    assert w.min() > 0


def test_msh_parser_unitsquare():
    import os

    path = "/root/reference/data/unitsquare.msh"
    if not os.path.exists(path):
        pytest.skip("reference mesh not available")
    from ddm_jax.fem import read_msh

    grid = read_msh(path)
    assert grid.elem_type == "tri"
    assert grid.dim == 2
    assert grid.n_nodes > 1000
    # area check: sum of |T| = 1
    x = grid.nodes[grid.elems]
    v1 = x[:, 1] - x[:, 0]
    v2 = x[:, 2] - x[:, 0]
    area = 0.5 * np.abs(v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0]).sum()
    assert abs(area - 1.0) < 1e-8


def test_chunked_element_assembly_matches_one_shot(monkeypatch):
    """Large element batches assemble in lax.map slabs (_chunked_elements,
    added after the 157k-hex one-shot einsums at the 3-D bench needed
    22.7 GB of temporaries).  Chunked and one-shot agree to contraction-order
    roundoff."""
    from ddm_jax.fem.assemble import (
        ElementQuadrature,
        assemble_convection_diffusion,
        assemble_linear_elasticity,
    )
    from ddm_jax.fem.grids import structured_grid
    from ddm_jax.fem import problems as pm

    grid = structured_grid((6, 6, 6))
    quad = ElementQuadrature("hex")
    xe = jnp.asarray(grid.nodes[grid.elems])
    prob = pm.islands()
    monkeypatch.setenv("DDM_ASSEMBLY_CHUNK", "0")
    K0, f0 = assemble_convection_diffusion(quad, xe, prob.alpha, prob.b,
                                           prob.c, prob.f)
    monkeypatch.setenv("DDM_ASSEMBLY_CHUNK", "50")
    K1, f1 = assemble_convection_diffusion(quad, xe, prob.alpha, prob.b,
                                           prob.c, prob.f)
    np.testing.assert_allclose(np.asarray(K1), np.asarray(K0),
                               rtol=1e-13, atol=1e-13 * float(jnp.abs(K0).max()))
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f0))

    ep = pm.steel_rubber_bar()
    monkeypatch.setenv("DDM_ASSEMBLY_CHUNK", "0")
    K0, f0 = assemble_linear_elasticity(quad, xe, ep.lam, ep.mu, ep.f)
    monkeypatch.setenv("DDM_ASSEMBLY_CHUNK", "37")
    K1, f1 = assemble_linear_elasticity(quad, xe, ep.lam, ep.mu, ep.f)
    np.testing.assert_allclose(np.asarray(K1), np.asarray(K0),
                               rtol=1e-13, atol=1e-13 * float(jnp.abs(K0).max()))
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f0))


def test_eliminate_dirichlet_dense_jit_matches_impl():
    """The donated-jit elimination path (engaged on non-CPU backends to
    rewrite the batch in place, r4) computes exactly what the eager impl
    does."""
    from ddm_jax.fem.subassembly import (
        _elim_impl,
        _elim_jit2,
        _elim_jit3,
        eliminate_dirichlet_dense,
    )

    rng = np.random.default_rng(7)
    A = jnp.asarray(rng.standard_normal((3, 10, 10)))
    d = jnp.asarray(rng.random((3, 10)) < 0.3)
    pad = jnp.asarray(rng.random((3, 10)) < 0.2)
    ref2 = _elim_impl(A, d, None)
    ref3 = _elim_impl(A, d, pad)
    # donation deletes the jit input — pass fresh copies, as the real
    # callers do (they rebind the name and never reuse the input)
    np.testing.assert_array_equal(np.asarray(_elim_jit2()(jnp.array(A), d)),
                                  np.asarray(ref2))
    np.testing.assert_array_equal(
        np.asarray(_elim_jit3()(jnp.array(A), d, pad)), np.asarray(ref3)
    )
    np.testing.assert_array_equal(
        np.asarray(eliminate_dirichlet_dense(jnp.array(A), d, pad)),
        np.asarray(ref3),
    )
