"""f32 contractions name their precision.

A GPU may compute an f32 product with no precision set in TF32 (~10 mantissa
bits), which breaks the double-single (dd) contract and shifts the
f32-seeded accept tests.  The CPU ignores precision, so only the traced
program can show it: every ``dot_general`` with an f32 operand in these
paths must carry ``Precision.HIGHEST``.  The same products are compared with
f64 on the card by ``chip_smoke.py`` and by the ``gpu`` test below.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ddm_jax.coarse.extension import _pcg_blocks_mixed_jit
from ddm_jax.eigen.dense_gevp import _gevp_speculative_jit, solve_gevp_dense
from ddm_jax.eigen.params import EigensolverParams
from ddm_jax.solvers import direct
from ddm_jax.solvers.krylov import fgmres_solve, gmres_solve

HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
N_SUB, P = 2, 12


def _f32_dots(jaxpr):
    """(precision, eqn) of every dot_general with an f32 operand, recursing
    into sub-jaxprs (jit, loops, conds)."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and any(
            v.aval.dtype == jnp.float32 for v in eqn.invars
        ):
            found.append((eqn.params["precision"], eqn))
        for sub in jax.core.jaxprs_in_params(eqn.params):
            found += _f32_dots(sub)
    return found


def _spd(seed=0, n_sub=N_SUB, p=P):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n_sub, p, p))
    return jnp.asarray(A @ np.swapaxes(A, 1, 2) + p * np.eye(p))


def _twice(x):
    return 2.0 * x


def _cases():
    A, C = _spd(0), _spd(1)
    hi, lo = direct.dd_split(A)
    d2 = jnp.ones((N_SUB, P))
    d3 = jnp.ones((N_SUB, P, 3))
    params = dataclasses.replace(
        EigensolverParams(), nev=2, nev_max=2, precision="f32")
    cols = jnp.zeros((N_SUB, P, 3), jnp.int32)
    vals = jnp.ones((N_SUB, P, 3))
    op = jax.tree_util.Partial(_twice)
    b = jnp.ones(8)
    return {
        "dd_matmul": (lambda: direct.dd_matmul(hi, lo, hi, lo), True),
        "dd_matvec": (lambda: direct.dd_matvec(hi, lo, d2), True),
        "dd_matvec_multi_rhs": (lambda: direct.dd_matvec(hi, lo, d3), True),
        "inverse_dd_refined": (lambda: direct.BatchedInverseDD(
            hi, lo, vals, cols, steps=2).solve(d2), True),
        "inverse_f32_refined": (lambda: direct.SparseRefinedInverse(
            hi, vals, cols).solve(d2), True),
        "inverse_f32_multi_rhs": (lambda: direct.BatchedInverse(
            hi).solve(d3), True),
        "newton_seed": (lambda: direct._f32_seed_inverse(A), True),
        "newton_seed_with_factor": (
            lambda: direct._f32_seed_inverse(A, with_factor=True), False),
        "whiten_stage": (
            lambda: direct._whiten_stage(A, jnp.zeros(N_SUB)), False),
        "gevp_f32_subspace_seed": (
            lambda: solve_gevp_dense(A, C, params), True),
        "gevp_f32_eigh_seed": (lambda: solve_gevp_dense(
            A, C, dataclasses.replace(params, seed_mode="eigh")), True),
        "gevp_f32_thin_s": (
            lambda: _gevp_speculative_jit(A, C, params), True),
        "extension_pcg_mixed": (
            lambda: _pcg_blocks_mixed_jit(3, 2)(A, A, d3), False),
        "gmres_dd_ortho": (lambda: gmres_solve(
            op, None, b, jnp.zeros(8), maxit=4, restart=2, ortho="dd"),
            True),
        "fgmres_dd_ortho": (lambda: fgmres_solve(
            op, None, b, jnp.zeros(8), maxit=4, restart=2, ortho="dd"),
            True),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_f32_contractions_run_at_highest_precision(name):
    fn, has_f32_dots = _cases()[name]
    dots = _f32_dots(jax.make_jaxpr(fn)().jaxpr)
    assert bool(dots) == has_f32_dots, [str(e) for _, e in dots]
    loose = [str(e) for prec, e in dots if prec != HIGHEST]
    assert not loose, loose


@pytest.mark.gpu
def test_dd_products_match_f64_on_gpu(gpu_device):
    """On the card, dd products agree with f64 to the f32-accumulation level
    (~1e-6); a TF32 product would read near 1e-3."""
    rng = np.random.default_rng(0)
    A = jax.device_put(jnp.asarray(rng.standard_normal((8, 256, 256))),
                       gpu_device)
    d = jax.device_put(jnp.asarray(rng.standard_normal((8, 256))),
                       gpu_device)
    hi, lo = direct.dd_split(A)
    ref = jnp.einsum("spq,sq->sp", A, d)
    y = direct.dd_matvec(hi, lo, d)
    assert float(jnp.linalg.norm(y - ref) / jnp.linalg.norm(ref)) < 1e-5
    ref_m = jnp.einsum("spq,sqr->spr", A, A)
    y_m = direct.dd_matmul(hi, lo, hi, lo)
    assert float(jnp.linalg.norm(y_m - ref_m) / jnp.linalg.norm(ref_m)) < 1e-5
