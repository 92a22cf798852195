"""Stencil fast-path SpMV (core/sparse.py): affine-pattern detection and
shift-based mv equivalence with the general gather path.

Motivation: structured patterns run as m contiguous shifted slices at memory
bandwidth instead of a 1-D-operand gather."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import scipy.sparse as sps

from ddm_jax.core.sparse import EllPattern, eliminate_dirichlet, jacobi_equilibrate
from ddm_jax.fem import structured_grid
from ddm_jax.fem.assemble import element_coo_indices


def _q1_pattern(cells=(12, 10)):
    grid = structured_grid(cells)
    rows, cols = element_coo_indices(grid.elems)
    return EllPattern.from_coo(rows, cols, grid.n_nodes)


def test_structured_pattern_detected():
    pat = _q1_pattern()
    assert pat.offsets is not None
    # 9-point Q1 stencil: offsets are {-nx-1..-nx+1, -1, 0, 1, nx-1..nx+1}
    nx = 13  # nodes per row for cells=(12, 10)
    assert set(pat.offsets) <= {d + s * nx for s in (-1, 0, 1) for d in (-1, 0, 1)}
    # offset-aligned slots: boundary rows just leave missing-neighbour slots
    # as padding, so no row needs the exact fix-up pass
    assert pat.fix_rows.size == 0


def test_stencil_mv_matches_general_and_scipy():
    pat = _q1_pattern()
    rng = np.random.default_rng(0)
    A = sps.random(pat.n, pat.n, density=0.0).tocsr()  # zero; use pattern vals
    vals = rng.normal(size=pat.slot_csr.size)
    A = sps.csr_matrix((vals, (pat.rows_csr, pat.cols_csr)), shape=(pat.n, pat.n))
    ell = pat.from_scipy_vals(A)
    assert ell.offsets is not None
    x = rng.normal(size=pat.n)
    y_st = np.asarray(ell.mv(jnp.asarray(x)))
    y_gen = np.asarray(ell._mv_general(jnp.asarray(x)))
    y_ref = A @ x
    np.testing.assert_allclose(y_st, y_ref, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(y_st, y_gen, rtol=1e-13, atol=1e-13)
    # multi-RHS
    X = rng.normal(size=(pat.n, 3))
    np.testing.assert_allclose(
        np.asarray(ell.mv(jnp.asarray(X))), A @ X, rtol=1e-13, atol=1e-13
    )


def test_unstructured_pattern_falls_back():
    rng = np.random.default_rng(1)
    n = 200
    rows = rng.integers(0, n, size=1200)
    cols = rng.integers(0, n, size=1200)
    # ensure a diagonal so no empty rows
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    pat = EllPattern.from_coo(rows, cols, n)
    assert pat.offsets is None
    A = sps.csr_matrix(
        (rng.normal(size=pat.slot_csr.size), (pat.rows_csr, pat.cols_csr)),
        shape=(n, n),
    )
    ell = pat.from_scipy_vals(A)
    assert ell.offsets is None
    x = rng.normal(size=n)
    np.testing.assert_allclose(
        np.asarray(ell.mv(jnp.asarray(x))), A @ x, rtol=1e-13, atol=1e-13
    )


def test_transforms_preserve_stencil_metadata():
    pat = _q1_pattern()
    rng = np.random.default_rng(2)
    # SPD-ish values so equilibration is well-posed
    A = sps.csr_matrix(
        (rng.uniform(0.5, 2.0, size=pat.slot_csr.size),
         (pat.rows_csr, pat.cols_csr)),
        shape=(pat.n, pat.n),
    )
    A = (A + A.T).tocsr() + 10.0 * sps.eye(pat.n)
    ell = pat.from_scipy_vals(A)
    dmask = jnp.zeros((pat.n,), bool).at[:5].set(True)
    for out in (
        eliminate_dirichlet(ell, dmask),
        jacobi_equilibrate(ell, jnp.ones((pat.n,)))[0],
        dataclasses.replace(ell, valsT=ell.valsT * 2),
    ):
        assert out.offsets == ell.offsets
        x = jnp.asarray(rng.normal(size=pat.n))
        np.testing.assert_allclose(
            np.asarray(out.mv(x)), np.asarray(out._mv_general(x)),
            rtol=1e-13, atol=1e-13,
        )


def test_tiled_take_exact():
    """tiled_take (bandwidth-class 1-D gather: row-gather + one-hot lane
    select) must be bit-exact pure data movement for any index shape,
    including tile-boundary indices and non-multiple-of-128 operands."""
    from ddm_jax.core.sparse import tiled_take

    rng = np.random.default_rng(3)
    for n in (130, 1000, 4096):
        x = jnp.asarray(rng.standard_normal(n))
        idx = jnp.asarray(rng.integers(0, n, size=(7, 345)))
        np.testing.assert_array_equal(
            np.asarray(tiled_take(x, idx)), np.asarray(x)[np.asarray(idx)]
        )
    x = jnp.arange(300, dtype=jnp.float64)
    idx = jnp.asarray([0, 127, 128, 129, 255, 256, 299])
    np.testing.assert_array_equal(
        np.asarray(tiled_take(x, idx)), np.asarray(x)[np.asarray(idx)]
    )
