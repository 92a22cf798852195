"""3-D box-canvas fast path (core/boxnd.py).

The N-D generalization of the 2-D rect canvas: on structured hex grids with
block partitions, detection must adopt the canvas, the gather/scatter layout
transforms must be EXACT against the general sub2glob maps, and every
consumer (dense stencil extraction, Schwarz/Galerkin applies, the shift-
grouped pairs coarse matrix, the sharded apply) must produce the same
results as the general path.  Mirrors the reference's dimension-agnostic
architecture (its MPI + sparse-direct machinery is identical for 2-D and
3-D — /root/reference/examples/poisson.cc works off a dim template
parameter); here the canvas layout is the part that had to be generalized

"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ddm_jax.core.setup as setup_mod
import ddm_jax.fem.problems as prob
from ddm_jax.api import default_ptree, setup_problem, solve
from ddm_jax.core.boxnd import (
    BoxMeta,
    box_gather,
    box_offset_decomp,
    box_scatter_add,
    detect_box_layout,
    relayout_box,
)
from ddm_jax.core.mesh import subdomain_mesh
from ddm_jax.fem.grids import structured_grid


def _problem_3d(coarse="none", gridsize=12, parts=(2, 2, 2)):
    pt = default_ptree()
    pt["overlap"] = 2
    pt["solver.type"] = "cgsolver"
    pt["solver.reduction"] = 1e-8
    pt["schwarz.type"] = "standard"
    pt["schwarz.subdomain_solver.type"] = "cholesky"
    if coarse != "none":
        pt["coarsespace.type"] = coarse
        pt[f"{coarse}.eigensolver.nev"] = 4
        pt[f"{coarse}.eigensolver.threshold"] = -1.0
    grid = structured_grid((gridsize,) * 3)
    return setup_problem(pt, grid=grid, parts=parts)


@pytest.fixture()
def no_canvas(monkeypatch):
    """Force the general (non-canvas) layout."""
    monkeypatch.setattr(
        setup_mod, "_try_rect_relayout", lambda topo, disc, pad_to: topo
    )


def test_box_layout_detected_3d():
    p = _problem_3d()
    meta = getattr(p.topo, "rect", None)
    assert isinstance(meta, BoxMeta)
    assert meta.ndim == 3
    assert meta.nparts == (2, 2, 2)
    assert meta.dims == (13, 13, 13)


def test_box_gather_exact_vs_sub2glob():
    p = _problem_3d()
    topo, meta = p.topo, p.topo.rect
    n = topo.n_glob
    x = np.random.default_rng(0).standard_normal(n)
    G = np.asarray(box_gather(jnp.asarray(x), meta))
    xe = np.concatenate([x, [0.0]])
    ref = xe[np.minimum(topo.sub2glob, n)] * topo.valid
    assert np.array_equal(G, ref)


def test_box_scatter_add_is_exact_adjoint():
    p = _problem_3d()
    topo, meta = p.topo, p.topo.rect
    Y = np.random.default_rng(1).standard_normal((topo.n_sub, topo.n_pad))
    Y = Y * topo.valid
    s = np.asarray(box_scatter_add(jnp.asarray(Y), meta))
    ref = np.zeros(topo.n_glob)
    for k in range(topo.n_sub):
        v = topo.valid[k]
        np.add.at(ref, topo.sub2glob[k][v], Y[k][v])
    np.testing.assert_allclose(s, ref, rtol=0, atol=1e-12)


def test_box_offset_decomp_27_point():
    p = _problem_3d()
    decomp = box_offset_decomp(p.A.offsets, p.topo.rect)
    assert decomp is not None and len(decomp) == len(p.A.offsets)
    # the 27-point hex stencil decomposes into per-axis steps in {-1, 0, 1}
    for steps in decomp:
        assert all(-1 <= s <= 1 for s in steps)


def test_dense_extraction_parity_3d(no_canvas):
    """The scatter-free canvas extraction must produce the same subdomain
    matrices (same values keyed by global dof ids) as the general
    extraction_map path."""
    from ddm_jax.core.indexmaps import extraction_map
    from ddm_jax.precond.extract import extract_subdomain_dense

    p = _problem_3d()
    topo = p.topo
    assert getattr(topo, "rect", None) is None  # fixture active
    local_cols = jnp.asarray(extraction_map(topo, np.asarray(p.A.colsT).T))
    E_gen = np.asarray(
        extract_subdomain_dense(
            p.A, jnp.asarray(topo.sub2glob), jnp.asarray(topo.valid),
            local_cols,
        )
    )

    dims = tuple(s + 1 for s in reversed(p.disc.grid.shape))
    meta = detect_box_layout(topo, dims, pad_to=8)
    assert meta is not None
    topo_c = relayout_box(topo, meta)
    E_box = np.asarray(
        extract_subdomain_dense(
            p.A, jnp.asarray(topo_c.sub2glob), jnp.asarray(topo_c.valid),
            None, rect=meta,
        )
    )
    # slot order differs between layouts: compare keyed by global ids
    for k in range(topo.n_sub):
        vg = topo.valid[k]
        vc = topo_c.valid[k]
        pg = np.argsort(topo.sub2glob[k][vg])
        pc = np.argsort(topo_c.sub2glob[k][vc])
        sg = np.flatnonzero(vg)[pg]
        sc = np.flatnonzero(vc)[pc]
        np.testing.assert_array_equal(
            topo.sub2glob[k][vg][pg], topo_c.sub2glob[k][vc][pc]
        )
        np.testing.assert_array_equal(
            E_gen[k][np.ix_(sg, sg)], E_box[k][np.ix_(sc, sc)]
        )


def test_box_vs_general_iterations_and_solution(monkeypatch):
    """Two-level GenEO in 3-D: canvas and general layouts must agree on the
    iteration count and the solution."""
    p_box = _problem_3d("geneo")
    assert isinstance(getattr(p_box.topo, "rect", None), BoxMeta)
    res_box = solve(p_box)
    assert bool(res_box.converged)
    monkeypatch.setattr(
        setup_mod, "_try_rect_relayout", lambda topo, disc, pad_to: topo
    )
    p_gen = _problem_3d("geneo")
    assert getattr(p_gen.topo, "rect", None) is None
    res_gen = solve(p_gen)
    assert int(res_box.iterations) == int(res_gen.iterations)
    x1, x2 = np.asarray(res_gen.x), np.asarray(res_box.x)
    assert np.linalg.norm(x1 - x2) <= 1e-10 * np.linalg.norm(x1)


def test_box_canvas_vector_valued_elasticity():
    """n_comp=3 3-D elasticity: dof id = node*3 + c folds into the fastest
    canvas axis; detection must adopt the canvas and the solve must match
    the general path."""
    grid = structured_grid((8, 8, 8), (0, 0, 0), (10.0, 1.0, 1.5))
    ep = prob.steel_rubber_bar()
    pt = default_ptree()
    pt["solver.reduction"] = 1e-8
    p = setup_problem(pt, problem=ep, grid=grid, parts=(2, 2, 2), n_comp=3)
    assert isinstance(getattr(p.topo, "rect", None), BoxMeta)
    res = solve(p)
    assert bool(res.converged)


def test_sharded_apply_parity_3d():
    """Sharded (8-device) solve on the 3-D box canvas must match the
    single-device iterates exactly (the sharded fast-path promise extended
    to 3-D)."""
    assert jax.device_count() >= 8
    mesh = subdomain_mesh(8)
    p = _problem_3d("geneo", parts=(2, 2, 2))
    assert isinstance(getattr(p.topo, "rect", None), BoxMeta)
    res_ref = solve(p)
    res_sh = solve(p, mesh=mesh)
    assert int(res_sh.iterations) == int(res_ref.iterations)
    np.testing.assert_allclose(
        np.asarray(res_sh.x), np.asarray(res_ref.x), rtol=1e-12, atol=1e-12
    )


def _mk_nonuniform(grid, parts, force_general=False, monkeypatch=None):
    pt = default_ptree()
    pt["overlap"] = 2
    pt["solver.type"] = "cgsolver"
    pt["schwarz.type"] = "standard"
    pt["schwarz.subdomain_solver.type"] = "cholesky"
    if force_general:
        monkeypatch.setattr(
            setup_mod, "_try_rect_relayout", lambda topo, disc, pad_to: topo
        )
    try:
        return setup_problem(pt, grid=grid, parts=parts)
    finally:
        if force_general:
            monkeypatch.undo()


def test_box_layout_nonuniform_pitch_3d():
    """Non-divisible 3-D grid (11 cells / 2 parts per axis -> part sizes
    6, 5): anchors are not uniformly pitched; the arithmetic-run grouping
    must still adopt the canvas with exact gather/scatter.  The reference
    accepts any partition (poisson.cc:129-133)."""
    p = _mk_nonuniform(structured_grid((11,) * 3), (2, 2, 2))
    topo = p.topo
    meta = getattr(topo, "rect", None)
    assert isinstance(meta, BoxMeta)
    n = topo.n_glob
    x = np.random.default_rng(0).standard_normal(n)
    G = np.asarray(box_gather(jnp.asarray(x), meta))
    xe = np.concatenate([x, [0.0]])
    ref = xe[np.minimum(topo.sub2glob, n)] * topo.valid
    assert np.array_equal(G, ref)
    Y = np.random.default_rng(1).standard_normal((topo.n_sub, topo.n_pad))
    Y = Y * topo.valid
    s = np.asarray(box_scatter_add(jnp.asarray(Y), meta))
    refs = np.zeros(n)
    for k in range(topo.n_sub):
        v = topo.valid[k]
        np.add.at(refs, topo.sub2glob[k][v], Y[k][v])
    np.testing.assert_allclose(s, refs, rtol=0, atol=1e-12)


def test_nonuniform_pitch_2d_box_fallback(monkeypatch):
    """22 cells / 4 parts per axis (sizes 6,6,5,5): the 2-D rect detector
    declines (anchor deltas 6,6,5), the N-D box canvas must pick it up, and
    the solve must match the general path bit-for-bit in iterations."""
    from ddm_jax.core.structured import detect_rect_layout

    grid = structured_grid((22, 22))
    p = _mk_nonuniform(grid, (4, 4))
    meta = getattr(p.topo, "rect", None)
    assert isinstance(meta, BoxMeta)  # rect declined, box adopted
    assert detect_rect_layout(p.topo, meta.dims) is None
    res = solve(p)
    assert bool(res.converged)
    p_gen = _mk_nonuniform(grid, (4, 4), force_general=True,
                           monkeypatch=monkeypatch)
    assert getattr(p_gen.topo, "rect", None) is None
    res_gen = solve(p_gen)
    assert int(res.iterations) == int(res_gen.iterations)
    x1, x2 = np.asarray(res.x), np.asarray(res_gen.x)
    assert np.linalg.norm(x1 - x2) <= 1e-10 * np.linalg.norm(x1)


def test_nonuniform_pitch_3d_geneo_parity(monkeypatch):
    """Two-level GenEO on the non-divisible 3-D grid: canvas vs general
    iteration/solution parity (exercises dense extraction, Neumann, POU and
    the pairs coarse matrix on the run-grouped canvas)."""
    pt = default_ptree()
    pt["overlap"] = 2
    pt["coarsespace.type"] = "geneo"
    pt["geneo.eigensolver.nev"] = 4
    pt["geneo.eigensolver.threshold"] = -1.0
    grid = structured_grid((11,) * 3)
    p_box = setup_problem(pt, grid=grid, parts=(2, 2, 2))
    assert isinstance(getattr(p_box.topo, "rect", None), BoxMeta)
    res_box = solve(p_box)
    assert bool(res_box.converged)
    monkeypatch.setattr(
        setup_mod, "_try_rect_relayout", lambda topo, disc, pad_to: topo
    )
    p_gen = setup_problem(pt, grid=grid, parts=(2, 2, 2))
    assert getattr(p_gen.topo, "rect", None) is None
    res_gen = solve(p_gen)
    assert int(res_box.iterations) == int(res_gen.iterations)
    x1, x2 = np.asarray(res_gen.x), np.asarray(res_box.x)
    assert np.linalg.norm(x1 - x2) <= 1e-10 * np.linalg.norm(x1)
