"""Scripted problems, masked scalar product, modify_subdomain_matrix,
example smoke runs."""

import numpy as np
import jax.numpy as jnp
import pytest

from ddm_jax.fem import problems as prob
from ddm_jax.fem.scripted import load_problem


def test_scripted_problem_matches_builtin():
    p = load_problem("ddm_jax/examples/coefficients/poisson_coefficient.py")
    rng = np.random.default_rng(0)
    xq = jnp.asarray(rng.uniform(size=(50, 2)))
    np.testing.assert_allclose(
        np.asarray(p.alpha(xq)), np.asarray(prob.islands().alpha(xq))
    )
    np.testing.assert_allclose(
        np.asarray(p.g(xq)), np.asarray(prob.islands().g(xq))
    )
    np.testing.assert_array_equal(
        np.asarray(p.is_dirichlet(xq)), np.asarray(prob.islands().is_dirichlet(xq))
    )


def test_scripted_symmetric_convection_diffusion():
    # symmetric_convection_diffusion_coefficient.lua:1-15: alpha = 1, f = 1,
    # Dirichlet on x = 0 and y = 1, g = 0
    p = load_problem(
        "ddm_jax/examples/coefficients/"
        "symmetric_convection_diffusion_coefficient.py"
    )
    xq = jnp.asarray([[0.0, 0.5], [0.5, 1.0], [0.5, 0.5], [1.0, 0.0]])
    np.testing.assert_allclose(np.asarray(p.alpha(xq)), 1.0)
    np.testing.assert_allclose(np.asarray(p.f(xq)), 1.0)
    np.testing.assert_array_equal(
        np.asarray(p.is_dirichlet(xq)), [True, True, False, False]
    )


def test_masked_dot():
    from ddm_jax.solvers.krylov import masked_dot, masked_norm

    x = jnp.asarray([1.0, 2.0, 3.0])
    m = jnp.asarray([True, False, True])
    assert float(masked_dot(x, x, m)) == 10.0
    assert abs(float(masked_norm(x, m)) - np.sqrt(10)) < 1e-14


def test_modify_subdomain_matrix_converges():
    from ddm_jax.api import default_ptree, setup_problem, solve

    pt = default_ptree()
    pt["gridsize"] = 32
    pt["modify_subdomain_matrix"] = True
    p = setup_problem(pt, problem=prob.simple(), parts=(2, 2))
    res = solve(p)
    assert bool(res.converged)


def test_example_smoke_poisson(tmp_path):
    from ddm_jax.examples.poisson import main

    main(["-gridsize", "16", "-subdomains", "4", "-visualise", "true",
          "-vtk_filename", str(tmp_path / "o.vtu"),
          "-solver.reduction", "1e-8"])
    assert (tmp_path / "o.vtu").exists()


def test_visualise_debug_fields(tmp_path):
    """VTK debug parity with poisson.cc:324-386: per-basis-vector fields of
    the debug subdomain, its POU/overlap indicator, the RHS, and the ring
    region (all-zero for non-ring coarse spaces)."""
    import re

    from ddm_jax.examples.poisson import main

    f = tmp_path / "dbg.vtu"
    main(["-gridsize", "16", "-subdomains", "4", "-visualise", "true",
          "-coarsespace.type", "geneo", "-geneo.eigensolver.nev", "2",
          "-geneo.eigensolver.threshold", "-1", "-debug_rank", "1",
          "-vtk_filename", str(f)])
    names = set(re.findall(r'Name="([^"]+)"', f.read_text()))
    assert {"solution", "rhs", "pou", "pou_sum", "ovlp_subdomain",
            "basis_vec_0000", "basis_vec_0001", "ring_region"} <= names


def test_example_smoke_scripted(tmp_path):
    from ddm_jax.examples.poisson import main

    main(["-gridsize", "16", "-subdomains", "4",
          "-coefficient_file",
          "ddm_jax/examples/coefficients/poisson_coefficient.py"])


def test_example_smoke_cli_elasticity():
    from ddm_jax.examples.cli import main

    main(["-problem", "elasticity", "-cells_x", "8", "-cells_y", "2",
          "-cells_z", "3", "-subdomains_x", "2"])
