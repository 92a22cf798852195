"""M5: linear elasticity (shipped config 4) — vector P1/Q1 assembly +
rigid-body/GenEO coarse spaces on the steel-reinforced rubber bar."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse.linalg as spla

from ddm_jax.api import DDMProblem, build_preconditioner, default_ptree, setup_problem
from ddm_jax.fem import structured_grid
from ddm_jax.fem import problems as prob
from ddm_jax.fem.assemble import (
    ElementQuadrature,
    assemble_linear_elasticity,
)
from ddm_jax.fem.discretize import Discretization
from ddm_jax.solvers.krylov import gmres_solve, operator_of, prec_of


def bar_problem(cells=(10, 4, 4)):
    """Scaled-down steel-rubber bar (reference: linearelasticity.{cc,hh} +
    coefficient.lua): box [0,10]x[0,1]x[0,1.5], clamped at x=0, gravity."""
    grid = structured_grid(cells, (0, 0, 0), (10.0, 1.0, 1.5))
    return grid, prob.steel_rubber_bar()


def test_element_matrix_symmetric_and_psd():
    grid, ep = bar_problem((2, 2, 2))
    quad = ElementQuadrature("hex")
    xe = jnp.asarray(grid.nodes[grid.elems])
    Ke, fe = assemble_linear_elasticity(quad, xe, ep.lam, ep.mu, ep.f)
    K = np.asarray(Ke)
    np.testing.assert_allclose(K, np.swapaxes(K, 1, 2), rtol=1e-12)
    w = np.linalg.eigvalsh(K[0])
    assert w.min() > -1e-6 * w.max()


def test_rigid_body_modes_in_kernel():
    """The unconstrained (Neumann) elastic operator annihilates translations
    and linearized rotations — exact for Q1 with 2x2x2 Gauss."""
    grid, ep = bar_problem((3, 2, 2))
    disc = Discretization(grid, ep, n_comp=3)
    A, b = disc.assemble()
    from ddm_jax.coarse.pou_space import rigid_body_modes

    modes = rigid_body_modes(grid.nodes, 3)
    assert len(modes) == 6
    Anorm = float(jnp.abs(A.valsT).max())
    for m in modes:
        r = A.mv(m)
        assert float(jnp.abs(r).max()) < 1e-9 * Anorm * float(jnp.abs(m).max() + 1)


def test_bar_solve_matches_scipy():
    grid, ep = bar_problem((8, 3, 3))
    pt = default_ptree()
    pt["solver.reduction"] = 1e-8
    p = setup_problem(pt, problem=ep, grid=grid, parts=(4, 1, 1), n_comp=3)
    from ddm_jax.api import solve, solution

    res = solve(p)
    assert bool(res.converged)
    u = solution(p, res)
    Ac, rhs, g = p.disc.constrained_system()
    u_ref = np.asarray(g) + spla.spsolve(
        p.disc.pattern.to_scipy(Ac).tocsc(), np.asarray(rhs)
    )
    scale = np.abs(u_ref).max()
    np.testing.assert_allclose(np.asarray(u), u_ref, atol=1e-5 * scale)


@pytest.mark.parametrize("cs", ["pou", "geneo"])
def test_bar_two_level(cs):
    grid, ep = bar_problem((8, 3, 3))
    pt = default_ptree()
    pt["solver.reduction"] = 1e-6
    pt["coarsespace.type"] = cs
    pt["coarse_solver.type"] = "lu"
    pt["geneo.eigensolver.nev"] = 6
    p = setup_problem(pt, problem=ep, grid=grid, parts=(4, 1, 1), n_comp=3)
    prec = build_preconditioner(p)
    res = gmres_solve(operator_of(p.A), prec_of(prec), p.rhs,
                      jnp.zeros_like(p.rhs), reduction=1e-6, maxit=300,
                      restart=50)
    assert bool(res.converged), cs
    assert int(res.iterations) <= 80, (cs, int(res.iterations))


def test_bar_simplex_tets_two_level_geneo():
    """The reference's actual elasticity setup (linearelasticity.cc:40-43):
    3D SIMPLEX bar (Kuhn tets from createSimplexGrid, [0,10]x[0,1]x[0,1.5]),
    vector-P1, steel-rubber coefficients, clamped at x=0, GenEO + GMRES."""
    grid = structured_grid((8, 2, 3), (0, 0, 0), (10.0, 1.0, 1.5), simplex=True)
    assert grid.elem_type == "tet"
    assert grid.n_elems == 8 * 2 * 3 * 6
    ep = prob.steel_rubber_bar()
    pt = default_ptree()
    pt["solver.reduction"] = 1e-6
    pt["coarsespace.type"] = "geneo"
    pt["coarse_solver.type"] = "lu"
    pt["geneo.eigensolver.nev"] = 8
    p = setup_problem(pt, problem=ep, grid=grid, n_sub=4, n_comp=3)
    prec = build_preconditioner(p)
    res = gmres_solve(operator_of(p.A), prec_of(prec), p.rhs,
                      jnp.zeros_like(p.rhs), reduction=1e-6, maxit=300,
                      restart=50)
    assert bool(res.converged)
    assert int(res.iterations) <= 100, int(res.iterations)
    # solution matches a direct solve
    from ddm_jax.api import solution

    u = solution(p, res)
    Ac, rhs, g = p.disc.constrained_system()
    u_ref = np.asarray(g) + spla.spsolve(
        p.disc.pattern.to_scipy(Ac).tocsc(), np.asarray(rhs))
    np.testing.assert_allclose(np.asarray(u), u_ref,
                               atol=1e-4 * np.abs(u_ref).max())


def test_elasticity_bar_msh():
    """Elasticity on the shipped bar.msh (2D triangle bar [0,10]x[-1,1]):
    vector-P1 on an unstructured simplex mesh, clamped at x=0, GenEO-RAS."""
    from ddm_jax.fem.msh import read_msh
    from ddm_jax.fem.problems import ElasticityProblem

    from conftest import reference_mesh

    grid = read_msh(reference_mesh("bar.msh"))
    assert grid.elem_type == "tri"
    ep = ElasticityProblem(
        lam=lambda x: jnp.full(x.shape[:-1], 100.0),
        mu=lambda x: jnp.full(x.shape[:-1], 10000.0),
        f=lambda x: jnp.stack(
            [jnp.zeros(x.shape[:-1]), jnp.full(x.shape[:-1], -9.81)], -1),
        g=lambda x: jnp.zeros(x.shape[:-1] + (2,)),
        is_dirichlet=lambda x: x[..., 0] < 1e-9,
        name="bar2d",
    )
    pt = default_ptree()
    pt["solver.reduction"] = 1e-6
    pt["coarsespace.type"] = "geneo"
    pt["coarse_solver.type"] = "lu"
    pt["geneo.eigensolver.nev"] = 8
    p = setup_problem(pt, problem=ep, grid=grid, n_sub=8, n_comp=2)
    prec = build_preconditioner(p)
    res = gmres_solve(operator_of(p.A), prec_of(prec), p.rhs,
                      jnp.zeros_like(p.rhs), reduction=1e-6, maxit=300,
                      restart=50)
    assert bool(res.converged)
    assert int(res.iterations) <= 100, int(res.iterations)
