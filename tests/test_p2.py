"""Degree-2 elements (P2 triangles, Q2 quads) — reference parity:
PkLocalFiniteElementMap degree 2 (nonlinearpoisson.cc:104)."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse.linalg as spla

from ddm_jax.fem import structured_grid
from ddm_jax.fem.discretize import Discretization
from ddm_jax.fem import problems as prob


def solve_poisson(grid, degree):
    problem = prob.Problem(
        f=lambda x: 2 * np.pi**2
        * jnp.sin(np.pi * x[..., 0]) * jnp.sin(np.pi * x[..., 1]),
    )
    disc = Discretization(grid, problem, degree=degree)
    A, rhs, g = disc.constrained_system()
    u = spla.spsolve(disc.pattern.to_scipy(A).tocsc(), np.asarray(rhs))
    xy = disc._node_coords
    exact = np.sin(np.pi * xy[:, 0]) * np.sin(np.pi * xy[:, 1])
    return np.abs(u - exact).max()


@pytest.mark.parametrize("simplex", [True, False])
def test_p2_superconverges_vs_p1(simplex):
    grid = structured_grid((8, 8), simplex=simplex)
    e1 = solve_poisson(grid, 1)
    e2 = solve_poisson(grid, 2)
    assert e2 < e1 / 8, (e1, e2)


@pytest.mark.parametrize("simplex", [True, False])
def test_p2_convergence_order(simplex):
    errs = [solve_poisson(structured_grid((nc, nc), simplex=simplex), 2)
            for nc in (4, 8)]
    # third order in the max norm for smooth solutions
    assert errs[0] / errs[1] > 6.0, errs


def test_p2_reproduces_quadratic_exactly():
    """u = x^2 + y^2 is in the P2 space: -Δu = -4, g = x²+y²."""
    grid = structured_grid((5, 5), simplex=True)
    problem = prob.Problem(
        f=lambda x: -4.0 * jnp.ones(x.shape[:-1]),
        g=lambda x: x[..., 0] ** 2 + x[..., 1] ** 2,
    )
    disc = Discretization(grid, problem, degree=2)
    A, rhs, g = disc.constrained_system()
    u = np.asarray(g) + spla.spsolve(
        disc.pattern.to_scipy(A).tocsc(), np.asarray(rhs)
    )
    xy = disc._node_coords
    exact = xy[:, 0] ** 2 + xy[:, 1] ** 2
    np.testing.assert_allclose(u, exact, atol=1e-9)


def test_p2_ddm_solve():
    from ddm_jax.api import default_ptree, setup_problem, solve

    grid = structured_grid((24, 24), simplex=True)
    pt = default_ptree()
    pt["solver.reduction"] = 1e-8
    disc_kwargs = {}
    from ddm_jax.api import DDMProblem, build_preconditioner
    from ddm_jax.core.setup import setup_topology
    from ddm_jax.core.indexmaps import pou_weights
    from ddm_jax.core.sparse import jacobi_equilibrate

    disc = Discretization(grid, prob.islands(), degree=2)
    A, rhs, g = disc.constrained_system()
    A, rhs, scale = jacobi_equilibrate(A, rhs)
    topo, ep = setup_topology(disc, overlap=2, n_sub=8)
    pou = pou_weights(topo, "distance")
    pt["coarsespace.type"] = "geneo"
    pt["coarse_solver.type"] = "cholesky"
    pt["geneo.eigensolver.nev"] = 8
    p = DDMProblem(disc=disc, topo=topo, A=A, rhs=rhs, g=g, pou=pou,
                   ptree=pt, elem_part=ep, scale=scale)
    prec = build_preconditioner(p)
    from ddm_jax.solvers.krylov import gmres_solve, operator_of, prec_of

    res = gmres_solve(operator_of(A), prec_of(prec), rhs, jnp.zeros_like(rhs),
                      reduction=1e-8, maxit=300, restart=50)
    assert bool(res.converged)
    assert int(res.iterations) <= 40


def test_p2_newton():
    """The reference's nonlinear config: P2 simplices + Newton."""
    from ddm_jax.fem.nonlinear import NonlinearDiscretization, NonlinearProblem
    from ddm_jax.solvers.nonlinear_driver import TwoLevelNewtonSolver
    from ddm_jax.config import ParamTree

    nlp = NonlinearProblem(q=lambda u: 10 * u * u, dq=lambda u: 20 * u,
                           f=lambda x: jnp.sum(x * x, -1))
    grid = structured_grid((16, 16), simplex=True)
    disc = NonlinearDiscretization(grid, nlp, degree=2)
    pt = ParamTree({
        "overlap": 2, "newton": {"Reduction": 1e-8},
        "solver": {"type": "bicgstabsolver", "maxit": 1000},
        "schwarz": {"type": "restricted",
                    "subdomain_solver": {"type": "umfpack"}},
        "coarse_solver": {"type": "lu"},
        "combined_preconditioner": {"mode": "multiplicative"},
        "pou": {"type": "distance", "shrink": 0},
    })
    solver = TwoLevelNewtonSolver(disc, pt, n_sub=4)
    res = solver.solve()
    assert res.converged
    assert res.iterations <= 8
