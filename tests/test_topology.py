"""DDM topology: overlap extension, boundary masks, partition of unity.

Ports the correctness intent of the reference tests
(tests/test_galerkin_coarse_matrix.cc:249-263 POU-sums-to-one check,
overlap-extension reproduction checks) to the host index-map layer.
"""

import numpy as np
import pytest
import scipy.sparse as sps

from ddm_jax.core.indexmaps import (
    build_topology,
    dof_membership_from_elems,
    dof_owner_lowest,
    partition_rcb,
    partition_structured,
    pou_weights,
)
from ddm_jax.core.sparse import EllPattern
from ddm_jax.fem import structured_grid
from ddm_jax.fem.assemble import element_coo_indices


def make_topo(cells=(16, 16), parts=(2, 2), overlap=2):
    grid = structured_grid(cells)
    part = partition_structured(cells, parts)
    rows, cols = element_coo_indices(grid.elems)
    adj = sps.csr_matrix(
        (np.ones(rows.size), (rows, cols)), shape=(grid.n_nodes, grid.n_nodes)
    )
    n_sub = int(part.max()) + 1
    M0 = dof_membership_from_elems(grid.elems, part, grid.n_nodes, n_sub)
    owner = dof_owner_lowest(grid.elems, part, grid.n_nodes)
    topo = build_topology(adj, M0, owner, overlap)
    return grid, part, topo


def test_partition_structured_balanced():
    part = partition_structured((16, 16), (4, 2))
    counts = np.bincount(part)
    assert len(counts) == 8
    assert counts.min() == counts.max() == 32


def test_rcb_balanced():
    rng = np.random.default_rng(0)
    pts = rng.uniform(size=(1000, 2))
    part = partition_rcb(pts, 6)
    counts = np.bincount(part, minlength=6)
    assert counts.max() - counts.min() <= 2


def test_overlap_extension_grows_monotonically():
    _, _, t0 = make_topo(overlap=0)
    _, _, t1 = make_topo(overlap=1)
    _, _, t2 = make_topo(overlap=2)
    assert (t0.sizes < t1.sizes).all()
    assert (t1.sizes < t2.sizes).all()


def test_every_dof_owned_once():
    grid, part, topo = make_topo()
    total_owner = np.zeros(grid.n_nodes + 1, dtype=int)
    np.add.at(total_owner, topo.sub2glob, topo.owner.astype(int))
    assert (total_owner[: grid.n_nodes] == 1).all()


def test_boundary_is_graph_boundary():
    grid, part, topo = make_topo(overlap=1)
    # brute-force check on subdomain 0: a member dof is boundary iff it has a
    # matrix-graph neighbour outside the subdomain
    rows, cols = element_coo_indices(grid.elems)
    adj = sps.csr_matrix(
        (np.ones(rows.size), (rows, cols)), shape=(grid.n_nodes, grid.n_nodes)
    ).tocsr()
    k = 0
    members = set(topo.sub2glob[k, topo.valid[k]].tolist())
    for p in range(topo.n_pad):
        if not topo.valid[k, p]:
            continue
        g = topo.sub2glob[k, p]
        nbrs = adj.indices[adj.indptr[g] : adj.indptr[g + 1]]
        is_bnd = any(int(nb) not in members for nb in nbrs)
        assert is_bnd == bool(topo.boundary[k, p]), (p, g)


@pytest.mark.parametrize("pou_type,shrink", [("standard", 0), ("distance", 0), ("distance", 1)])
def test_pou_sums_to_one(pou_type, shrink):
    grid, part, topo = make_topo(overlap=2)
    w = pou_weights(topo, pou_type, shrink=shrink)
    total = np.zeros(grid.n_nodes + 1)
    np.add.at(total, topo.sub2glob, w)
    np.testing.assert_allclose(total[: grid.n_nodes], 1.0, atol=1e-12)


def test_pou_trivial_is_owner_indicator():
    grid, part, topo = make_topo()
    w = pou_weights(topo, "trivial")
    np.testing.assert_array_equal(w > 0, topo.owner)
    total = np.zeros(grid.n_nodes + 1)
    np.add.at(total, topo.sub2glob, w)
    np.testing.assert_allclose(total[: grid.n_nodes], 1.0)


def test_pou_zero_on_subdomain_boundary():
    grid, part, topo = make_topo()
    for pt in ("standard", "distance"):
        w = pou_weights(topo, pt)
        assert (w[topo.boundary] == 0).all()


def test_shrink_validation():
    grid, part, topo = make_topo(overlap=2)
    with pytest.raises(ValueError):
        pou_weights(topo, "distance", shrink=2)  # must be < overlap
    with pytest.raises(ValueError):
        pou_weights(topo, "distance", shrink=-1)


def test_general_extraction_chunked_parity(monkeypatch):
    """Regression for the r4 unstructured-audit OOM fixes: drive the
    GENERAL (non-canvas) extraction + stamp-sum Neumann + geneo build at a
    size where the chunked/donated slab paths actually engage
    (DDM_EXTRACT_ONESHOT_BYTES + DDM_BATCH_CHUNK forced small), and pin
    bitwise extraction parity + end-to-end solution parity against the
    one-shot paths."""
    import jax.numpy as jnp

    from ddm_jax.api import build_preconditioner, default_ptree, \
        setup_problem, solve
    from ddm_jax.core.indexmaps import extraction_map
    from ddm_jax.core.mesh import batched
    from ddm_jax.fem import problems as pm
    from ddm_jax.fem.grids import refine
    from ddm_jax.fem.msh import read_msh
    from ddm_jax.precond.extract import extract_subdomain_dense

    from conftest import reference_mesh

    grid = refine(read_msh(reference_mesh("lshape.msh")), 1)
    pt = default_ptree()
    pt["overlap"] = 2
    pt["coarsespace.type"] = "geneo"
    pt["geneo.eigensolver.nev"] = 4
    pt["geneo.eigensolver.threshold"] = -1.0
    p = setup_problem(pt, problem=pm.islands(), grid=grid, n_sub=8)
    assert getattr(p.topo, "rect", None) is None  # general path
    lc = batched(extraction_map(p.topo, np.asarray(p.A.colsT).T))
    s2g, val = batched(p.topo.sub2glob), batched(p.topo.valid)

    E_one = np.asarray(extract_subdomain_dense(p.A, s2g, val, lc))
    res_one = solve(p)

    # force every slab/donated path on
    monkeypatch.setenv("DDM_EXTRACT_ONESHOT_BYTES", "1")
    monkeypatch.setenv("DDM_BATCH_CHUNK", "3")  # 8 subdomains -> 3 slabs
    E_chunk = np.asarray(extract_subdomain_dense(p.A, s2g, val, lc))
    np.testing.assert_array_equal(E_one, E_chunk)

    p2 = setup_problem(pt, problem=pm.islands(), grid=grid, n_sub=8)
    res_chunk = solve(p2)
    assert int(res_chunk.iterations) == int(res_one.iterations)
    x1, x2 = np.asarray(res_one.x), np.asarray(res_chunk.x)
    assert np.linalg.norm(x1 - x2) <= 1e-10 * np.linalg.norm(x1)
