"""Structured-rect canvas layout + bandwidth gather/scatter
(ddm_jax/core/structured.py)."""
import dataclasses

import numpy as np
import jax.numpy as jnp

from ddm_jax.api import build_preconditioner, default_ptree, setup_problem, solve
from ddm_jax.core.structured import rect_gather, rect_scatter_add
from ddm_jax.precond.extract import gather_subdomain, scatter_add_subdomain
from ddm_jax.core.mesh import batched
from ddm_jax.fem import problems as pm


def _problem(gridsize=64, parts=(4, 4), **keys):
    pt = default_ptree()
    pt["gridsize"] = gridsize
    pt["overlap"] = 2
    for k, v in keys.items():
        pt[k] = v
    return setup_problem(pt, problem=pm.islands(), parts=parts)


def test_detection_and_gather_scatter_equivalence():
    p = _problem()
    topo = p.topo
    meta = getattr(topo, "rect", None)
    assert meta is not None, "structured 64^2/16 must take the rect layout"
    assert meta.n_pad == topo.n_pad

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=topo.n_glob))
    g_fast = rect_gather(x, meta)
    g_ref = gather_subdomain(x, batched(topo.sub2glob))
    np.testing.assert_allclose(np.asarray(g_fast), np.asarray(g_ref),
                               rtol=0, atol=0)

    y_sub = rng.normal(size=(topo.n_sub, topo.n_pad))
    y_sub[~np.asarray(topo.valid)] = 0.0  # contract: padding slots zero
    y_sub = jnp.asarray(y_sub)
    s_fast = rect_scatter_add(y_sub, meta)
    s_ref = scatter_add_subdomain(y_sub, batched(topo.sub2glob), topo.n_glob)
    np.testing.assert_allclose(np.asarray(s_fast), np.asarray(s_ref),
                               rtol=1e-14, atol=1e-14)

    # adjointness <G x, y> == <x, S y>
    lhs = float(jnp.vdot(g_fast, y_sub))
    rhs = float(jnp.vdot(x, s_fast))
    assert abs(lhs - rhs) < 1e-10 * max(abs(lhs), 1.0)


def test_rect_layout_nonsquare_parts():
    p = _problem(parts=(4, 2))
    assert getattr(p.topo, "rect", None) is not None
    res = solve(p)
    assert bool(res.converged)


def test_rect_layout_vector_q1_elasticity():
    """dof id = node*n_comp + c keeps subdomains contiguous rects of the
    (n_nodes_slow, n_nodes_fast*n_comp) dof grid — vector problems take the
    fast path too."""
    import jax.numpy as jnp

    from ddm_jax.fem.grids import structured_grid
    from ddm_jax.fem.problems import ElasticityProblem

    ep = ElasticityProblem(
        lam=lambda x: jnp.full(x.shape[:-1], 100.0),
        mu=lambda x: jnp.full(x.shape[:-1], 1000.0),
        f=lambda x: jnp.stack([jnp.zeros(x.shape[:-1]),
                               jnp.full(x.shape[:-1], -9.81)], -1),
        g=lambda x: jnp.zeros(x.shape[:-1] + (2,)),
        is_dirichlet=lambda x: x[..., 0] < 1e-9,
        name="plate2d",
    )
    pt = default_ptree()
    pt["overlap"] = 2
    pt["coarsespace.type"] = "geneo"
    pt["coarse_solver.type"] = "lu"
    pt["geneo.eigensolver.nev"] = 4
    p = setup_problem(pt, problem=ep, grid=structured_grid((32, 32)),
                      parts=(4, 4), n_comp=2)
    assert getattr(p.topo, "rect", None) is not None
    prec = build_preconditioner(p)
    rng = np.random.default_rng(0)
    d = jnp.asarray(rng.normal(size=p.topo.n_glob))
    for sub in prec.precs:
        slow = dataclasses.replace(sub, rect=None)
        np.testing.assert_allclose(
            np.asarray(sub.apply(d)), np.asarray(slow.apply(d)),
            rtol=1e-13, atol=1e-13)


def test_uneven_partition_takes_box_canvas():
    # 50 cells over 4 parts -> non-uniform anchor pitch: the 2-D rect
    # detector declines, but since round 5 the N-D box canvas picks the
    # layout up via arithmetic anchor runs — and its
    # gather must stay exact against the general maps
    from ddm_jax.core.boxnd import BoxMeta, box_gather

    p = _problem(gridsize=50)
    meta = getattr(p.topo, "rect", None)
    assert isinstance(meta, BoxMeta)
    topo = p.topo
    x = np.random.default_rng(3).standard_normal(topo.n_glob)
    G = np.asarray(box_gather(jnp.asarray(x), meta))
    xe = np.concatenate([x, [0.0]])
    ref = xe[np.minimum(topo.sub2glob, topo.n_glob)] * topo.valid
    assert np.array_equal(G, ref)
    res = solve(p)
    assert bool(res.converged)


def test_two_level_apply_fast_equals_general():
    p = _problem(**{"coarsespace.type": "geneo",
                    "geneo.eigensolver.nev": 4})
    prec = build_preconditioner(p)
    rng = np.random.default_rng(1)
    d = jnp.asarray(rng.normal(size=p.topo.n_glob))
    for sub in prec.precs:
        assert sub.rect is not None
        slow = dataclasses.replace(sub, rect=None)
        np.testing.assert_allclose(
            np.asarray(sub.apply(d)), np.asarray(slow.apply(d)),
            rtol=1e-13, atol=1e-13,
        )


def test_rect_dense_extraction_equals_general():
    """Scatter-free stencil extraction (rect_dense_from_stencil) must equal
    the general gather+scatter path bit-for-bit (same values, different
    placement only)."""
    from ddm_jax.core.indexmaps import extraction_map
    from ddm_jax.precond.extract import _rect_stencil_meta, extract_subdomain_dense

    for kwargs in ({}, {"parts": (4, 2)}):
        p = _problem(**kwargs)
        topo = p.topo
        assert topo.rect is not None and p.A.offsets is not None
        assert _rect_stencil_meta(topo.rect, p.A.offsets) is not None
        lc = batched(extraction_map(topo, np.asarray(p.A.colsT).T))
        args = (p.A, batched(topo.sub2glob), batched(topo.valid), lc)
        for unit in (True, False):
            fast = extract_subdomain_dense(
                *args, unit_padding_diag=unit, rect=topo.rect)
            gen = extract_subdomain_dense(
                *args, unit_padding_diag=unit, rect=None)
            np.testing.assert_allclose(
                np.asarray(fast), np.asarray(gen), rtol=0, atol=0)


def test_rect_dense_extraction_vector_q1():
    from ddm_jax.fem.grids import structured_grid
    from ddm_jax.fem.problems import ElasticityProblem
    from ddm_jax.core.indexmaps import extraction_map
    from ddm_jax.precond.extract import _rect_stencil_meta, extract_subdomain_dense

    ep = ElasticityProblem(
        lam=lambda x: jnp.full(x.shape[:-1], 100.0),
        mu=lambda x: jnp.full(x.shape[:-1], 1000.0),
        f=lambda x: jnp.stack([jnp.zeros(x.shape[:-1]),
                               jnp.full(x.shape[:-1], -9.81)], -1),
        g=lambda x: jnp.zeros(x.shape[:-1] + (2,)),
        is_dirichlet=lambda x: x[..., 0] < 1e-9,
        name="plate2d",
    )
    pt = default_ptree()
    pt["overlap"] = 2
    p = setup_problem(pt, problem=ep, grid=structured_grid((32, 32)),
                      parts=(4, 4), n_comp=2)
    topo = p.topo
    assert topo.rect is not None and p.A.offsets is not None
    assert _rect_stencil_meta(topo.rect, p.A.offsets) is not None
    lc = batched(extraction_map(topo, np.asarray(p.A.colsT).T))
    fast = extract_subdomain_dense(
        p.A, batched(topo.sub2glob), batched(topo.valid), lc, rect=topo.rect)
    gen = extract_subdomain_dense(
        p.A, batched(topo.sub2glob), batched(topo.valid), lc, rect=None)
    np.testing.assert_allclose(np.asarray(fast), np.asarray(gen),
                               rtol=0, atol=0)


def test_neumann_subtraction_equals_stamp_sum():
    """A_dir-subtraction Neumann assembly (crossing stamps only) must match
    the fully-inside stamp-sum path on both the subdomain (A_neu) and the
    overlap-region (B_neu) matrices, and on a ring region_neumann."""
    from ddm_jax.coarse.geneo import (
        _neumann_fast_ok, neumann_matrices, region_neumann,
    )

    p = _problem()  # islands 64²/16, contrast 1e6, equilibrated
    assert _neumann_fast_ok(p)
    A_f, B_f = neumann_matrices(p, method="subtract")
    A_s, B_s = neumann_matrices(p, method="sum")
    scale = float(jnp.max(jnp.abs(A_s)))
    np.testing.assert_allclose(np.asarray(A_f), np.asarray(A_s),
                               rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(np.asarray(B_f), np.asarray(B_s),
                               rtol=0, atol=1e-12 * scale)

    topo = p.topo
    ring = topo.valid & (topo.bdist <= 2 * topo.overlap + 1)
    R_f = region_neumann(p, ring, method="subtract")
    R_s = region_neumann(p, ring, method="sum")
    np.testing.assert_allclose(np.asarray(R_f), np.asarray(R_s),
                               rtol=0, atol=1e-12 * scale)


def test_neumann_subtraction_unequilibrated():
    pt = default_ptree()
    pt["gridsize"] = 48
    pt["overlap"] = 2
    pt["equilibrate"] = False
    p = setup_problem(pt, problem=pm.islands(), parts=(4, 4))
    from ddm_jax.coarse.geneo import _neumann_fast_ok, neumann_matrices

    assert _neumann_fast_ok(p)
    A_f, B_f = neumann_matrices(p, method="subtract")
    A_s, B_s = neumann_matrices(p, method="sum")
    scale = float(jnp.max(jnp.abs(A_s)))
    np.testing.assert_allclose(np.asarray(A_f), np.asarray(A_s),
                               rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(np.asarray(B_f), np.asarray(B_s),
                               rtol=0, atol=1e-12 * scale)


def test_chunked_placement_matches_one_shot():
    """The slab-chunked extraction placement (r4: the 3-D bench's one-shot
    band array exhausted HBM) is bitwise equal to the one-shot path."""
    import jax.numpy as jnp

    from ddm_jax.api import default_ptree, setup_problem
    from ddm_jax.precond.extract import (
        _rect_dense_jit,
        _rect_place_jit,
        _rect_streams_jit,
    )
    from ddm_jax.solvers.direct import chunked_batch

    pt = default_ptree()
    pt["gridsize"] = 24
    p = setup_problem(pt, parts=(4, 2))
    rect = p.topo.rect
    assert rect is not None
    valid = jnp.asarray(p.topo.valid)
    one = _rect_dense_jit(rect, p.A.offsets, True)(p.A.valsT, valid)
    G = _rect_streams_jit(rect, p.A.offsets)(p.A.valsT, valid)
    place = _rect_place_jit(rect, p.A.offsets, True)
    chunked = chunked_batch(
        lambda Gt, v: place(jnp.moveaxis(Gt, 0, 1), v),
        jnp.moveaxis(G, 0, 1), valid, chunk=3,
    )
    np.testing.assert_array_equal(np.asarray(chunked), np.asarray(one))


def test_chunked_batch_in_place_fill_matches_concat():
    """chunked_batch's donated in-place fill path (engaged when unsharded
    and every output leaf is batch-leading; r4 — the list+concatenate
    variant held 2x the batch and OOMed the 3-D extraction) is bitwise
    equal to the one-shot call, for single-array and tuple outputs."""
    import jax.numpy as jnp

    from ddm_jax.solvers.direct import chunked_batch

    rng = np.random.default_rng(5)
    A = jnp.asarray(rng.standard_normal((13, 6, 6)))

    fn = lambda a: a @ jnp.swapaxes(a, 1, 2)  # noqa: E731
    np.testing.assert_array_equal(
        np.asarray(chunked_batch(fn, A, chunk=4)), np.asarray(fn(A))
    )

    fn2 = lambda a: (a.sum(axis=(1, 2)), a * 2.0)  # noqa: E731
    got = chunked_batch(fn2, A, chunk=5)
    ref = fn2(A)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))

    # a non-batch-leading output (scalar reduction) must fall back to concat
    # behavior... (it cannot: leading dim mismatch -> accumulate+concat path)
    fn3 = lambda a: a.reshape(-1)  # noqa: E731
    np.testing.assert_array_equal(
        np.asarray(chunked_batch(fn3, A, chunk=4)), np.asarray(A.reshape(-1))
    )
