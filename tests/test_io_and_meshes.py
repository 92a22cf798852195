"""MatrixMarket IO round trips + tetrahedral meshes end-to-end."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse.linalg as spla

from ddm_jax.core.io import read_matrix_market, write_matrix_market
from ddm_jax.fem import read_msh
from ddm_jax.fem import problems as prob
from ddm_jax.fem.discretize import Discretization


def test_matrix_market_roundtrip(tmp_path):
    mm = """%%MatrixMarket matrix coordinate real general
3 3 5
1 1 2.0
1 2 -1.0
2 2 2.0
3 2 -1.0
3 3 2.0
"""
    pat, ell = read_matrix_market(mm)
    dense = pat.to_scipy(ell).toarray()
    np.testing.assert_allclose(
        dense, [[2, -1, 0], [0, 2, 0], [0, -1, 2]]
    )
    path = str(tmp_path / "a.mtx")
    write_matrix_market(path, pat, ell)
    pat2, ell2 = read_matrix_market(path)
    np.testing.assert_allclose(pat2.to_scipy(ell2).toarray(), dense)


@pytest.mark.parametrize("mesh,etype", [("unitcube.msh", "tet"),
                                        ("bar.msh", "tri"),
                                        ("lshape.msh", "tri")])
def test_reference_meshes_poisson(mesh, etype):
    path = f"/root/reference/data/{mesh}"
    if not os.path.exists(path):
        pytest.skip("mesh unavailable")
    grid = read_msh(path)
    assert grid.elem_type == etype
    if etype == "tet":
        x = grid.nodes[grid.elems]
        v = np.abs(np.linalg.det(x[:, 1:] - x[:, :1])).sum() / 6.0
        assert abs(v - 1.0) < 1e-6

    disc = Discretization(grid, prob.simple())
    A, rhs, g = disc.constrained_system()
    u = spla.spsolve(disc.pattern.to_scipy(A).tocsc(), np.asarray(rhs))
    assert np.isfinite(u).all() and u.max() > 0


def test_tet_mesh_ddm_solve():
    path = "/root/reference/data/unitcube.msh"
    if not os.path.exists(path):
        pytest.skip("mesh unavailable")
    from ddm_jax.api import default_ptree, setup_problem, solve

    grid = read_msh(path)
    pt = default_ptree()
    pt["overlap"] = 2
    p = setup_problem(pt, problem=prob.simple(), grid=grid, n_sub=8)
    res = solve(p)
    assert bool(res.converged)
    assert int(res.iterations) <= 60


def test_refine_unstructured_tri():
    """Edge-midpoint refinement of a triangle .msh mesh
    (ddm_utilities.hh:86-89 globalRefine equivalent)."""
    from ddm_jax.fem.grids import Grid, refine, structured_grid

    g = structured_grid((3, 3), simplex=True)
    g = Grid(nodes=g.nodes, elems=g.elems, elem_type="tri")  # mark unstructured
    r = refine(g, 1)
    assert r.n_elems == 4 * g.n_elems
    # area preserved
    def area(grid):
        X = grid.nodes[grid.elems]
        v1, v2 = X[:, 1] - X[:, 0], X[:, 2] - X[:, 0]
        return np.abs(v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0]).sum() / 2
    np.testing.assert_allclose(area(r), area(g))
    # no duplicate nodes
    assert np.unique(r.nodes, axis=0).shape[0] == r.nodes.shape[0]


def test_refine_unstructured_tet():
    """Bey's red refinement of tets: 8 children, volume preserved."""
    from ddm_jax.fem.grids import refine
    from ddm_jax.fem.msh import read_msh

    from conftest import reference_mesh

    g = read_msh(reference_mesh("unitcube.msh"))
    assert g.elem_type == "tet"
    r = refine(g, 1)
    assert r.n_elems == 8 * g.n_elems

    def vol(grid):
        X = grid.nodes[grid.elems]
        a, b, c = X[:, 1] - X[:, 0], X[:, 2] - X[:, 0], X[:, 3] - X[:, 0]
        return np.abs(np.einsum("ed,ed->e", a, np.cross(b, c))).sum() / 6

    np.testing.assert_allclose(vol(r), vol(g), rtol=1e-12)
    # every child must have positive volume (no degenerate tets)
    X = r.nodes[r.elems]
    a, b, c = X[:, 1] - X[:, 0], X[:, 2] - X[:, 0], X[:, 3] - X[:, 0]
    assert (np.abs(np.einsum("ed,ed->e", a, np.cross(b, c))) > 1e-14).all()
