"""Native C++ topology kernel: must agree exactly with the scipy path."""

import numpy as np
import pytest
import scipy.sparse as sps

from ddm_jax._native import build, load
from ddm_jax.core.indexmaps import (
    build_topology,
    dof_membership_from_elems,
    dof_owner_lowest,
)
from ddm_jax.core.setup import partition_elements
from ddm_jax.fem import structured_grid
from ddm_jax.fem.discretize import Discretization
from ddm_jax.fem import problems as prob


def test_native_builds():
    assert build() is not None, "g++ compilation of ddmcore failed"
    assert load() is not None


@pytest.mark.parametrize("overlap", [1, 2, 3])
def test_native_matches_python(overlap):
    grid = structured_grid((20, 20))
    disc = Discretization(grid, prob.simple())
    part = partition_elements(disc, parts=(2, 2))
    adj = disc.adjacency()
    M0 = dof_membership_from_elems(grid.elems, part, disc.n_dofs, 4)
    owner = dof_owner_lowest(grid.elems, part, disc.n_dofs)

    t_py = build_topology(adj, M0, owner, overlap, use_native=False)
    t_cc = build_topology(adj, M0, owner, overlap, use_native=True)

    np.testing.assert_array_equal(t_py.sub2glob, t_cc.sub2glob)
    np.testing.assert_array_equal(t_py.valid, t_cc.valid)
    np.testing.assert_array_equal(t_py.owner, t_cc.owner)
    np.testing.assert_array_equal(t_py.boundary, t_cc.boundary)
    np.testing.assert_array_equal(
        np.minimum(t_py.bdist, t_py.bdist_cap),
        np.minimum(t_cc.bdist, t_cc.bdist_cap),
    )
    np.testing.assert_array_equal(t_py.glob2loc, t_cc.glob2loc)


def test_native_unstructured():
    import os

    path = "/root/reference/data/unitsquare.msh"
    if not os.path.exists(path):
        pytest.skip("mesh unavailable")
    from ddm_jax.fem import read_msh

    grid = read_msh(path)
    disc = Discretization(grid, prob.simple())
    part = partition_elements(disc, n_sub=8)
    adj = disc.adjacency()
    M0 = dof_membership_from_elems(grid.elems, part, disc.n_dofs, 8)
    owner = dof_owner_lowest(grid.elems, part, disc.n_dofs)
    t_py = build_topology(adj, M0, owner, 2, use_native=False)
    t_cc = build_topology(adj, M0, owner, 2, use_native=True)
    np.testing.assert_array_equal(t_py.sub2glob, t_cc.sub2glob)
    np.testing.assert_array_equal(t_py.boundary, t_cc.boundary)
    np.testing.assert_array_equal(t_py.bdist, t_cc.bdist)
