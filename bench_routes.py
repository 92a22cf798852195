#!/usr/bin/env python
"""Time both routes of every backend branch at the flagship's shapes.

Several setup and apply steps choose a route with
``jax.default_backend() == "cpu"``: the accelerator route on a GPU, the
other route on the CPU.  This script runs on a GPU only (it exits non-zero
elsewhere) and times, on the card, the route the GPU takes beside the one it
does not, so that the choice can be judged on the card.  Each timing is
warm (compiled beforehand) and the median of a few repetitions.

    python bench_routes.py

Prints the card's name and power limit, one line per branch, and finally one
JSON object with every timing.  End-to-end rows rebuild bench.py's flagship
preconditioner with one configuration key changed and report warm setup and
solve times, the iteration count and the relevant Logger phase.
"""

import copy
import dataclasses
import json
import os
import statistics
import sys
import time

REPS = 5


def say(*args):
    print(*args, flush=True)


def timed(fn, *args, reps=REPS, fresh=None):
    """Median wall time of ``fn(*args)`` after one compiling call.
    ``fresh`` makes new arguments for every call (for donated buffers)."""
    import jax

    def once():
        a = fresh() if fresh is not None else args
        jax.block_until_ready(a)
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*a))
        return time.perf_counter() - t0

    once()
    return statistics.median(once() for _ in range(reps))


def end_to_end(p, key=None, value=None, phase=None):
    """Warm flagship setup + solve with ``ptree[key] = value``."""
    import jax

    from ddm_jax import api
    from ddm_jax.obs.logger import Logger

    if key is not None:
        pt = copy.deepcopy(p.ptree)
        pt[key] = value
        p = dataclasses.replace(p, ptree=pt)
    rec = {}
    for _ in range(2):  # cold, then the warm run that is kept
        Logger.reset()
        t0 = time.perf_counter()
        prec = api.build_preconditioner(p)
        jax.block_until_ready(prec)
        t1 = time.perf_counter()
        res = api.solve(p, prec=prec)
        jax.block_until_ready(res)
        t2 = time.perf_counter()
        rec = dict(setup_s=t1 - t0, solve_s=t2 - t1,
                   iterations=int(res.iterations))
        if phase is not None:
            ev = Logger.get().events.get(phase)
            rec["phase_s"] = ev.total if ev is not None else None
        del prec, res
    return rec


def main():
    import jax

    if jax.default_backend() != "gpu":
        say(f"bench_routes.py needs a GPU; JAX found {jax.default_backend()!r}")
        sys.exit(1)
    import jax.numpy as jnp

    import bench
    from chip_smoke import FLAGSHIP, subdomain_batch
    from ddm_jax.fem import subassembly
    from ddm_jax.solvers import direct

    say(bench.gpu_name_and_power_limit())
    results = {}

    p = bench.build_problem(**FLAGSHIP)
    A = subdomain_batch(p)
    n_sub, n_pad, _ = A.shape

    # f32 products at the flagship's shapes: HIGHEST (what the library
    # names) vs the default precision, error against f64 and time
    hi, lo = direct.dd_split(jax.random.normal(
        jax.random.PRNGKey(2), A.shape, A.dtype))
    dense = hi.astype(A.dtype) + lo.astype(A.dtype)
    v = jax.random.normal(jax.random.PRNGKey(3), (n_sub, n_pad), A.dtype)
    row = {}
    for name, prec in (("highest", jax.lax.Precision.HIGHEST),
                       ("default", None)):
        def mm(h, l, pr=prec):
            t0 = jnp.einsum("spq,sqr->spr", h, h, precision=pr)
            t1 = (jnp.einsum("spq,sqr->spr", l, h, precision=pr)
                  + jnp.einsum("spq,sqr->spr", h, l, precision=pr))
            return t0.astype(jnp.float64) + t1.astype(jnp.float64)

        def mv(h, l, x, pr=prec):
            xh = x.astype(jnp.float32)
            xl = (x - xh.astype(jnp.float64)).astype(jnp.float32)
            y0 = jnp.einsum("spq,sq->sp", h, xh, precision=pr)
            y1 = (jnp.einsum("spq,sq->sp", l, xh, precision=pr)
                  + jnp.einsum("spq,sq->sp", h, xl, precision=pr))
            return y0.astype(jnp.float64) + y1.astype(jnp.float64)

        mm, mv = jax.jit(mm), jax.jit(mv)
        ref_mm = jnp.einsum("spq,sqr->spr", dense, dense,
                            precision=jax.lax.Precision.HIGHEST)
        ref_mv = jnp.einsum("spq,sq->sp", dense, v)
        row[name] = dict(
            matmul_rel_err=float(jnp.linalg.norm(mm(hi, lo) - ref_mm)
                                 / jnp.linalg.norm(ref_mm)),
            matvec_rel_err=float(jnp.linalg.norm(mv(hi, lo, v) - ref_mv)
                                 / jnp.linalg.norm(ref_mv)),
            matmul_s=timed(mm, hi, lo), matvec_s=timed(mv, hi, lo, v))
        del ref_mm
    results["f32_precision"] = row
    del hi, lo, dense, v

    # direct.py factor_batched mode: "inverse" (GPU) vs "factors" (CPU);
    # setup, then one single-vector apply per GMRES iteration
    d = jax.random.normal(jax.random.PRNGKey(0), (n_sub, n_pad), A.dtype)
    row = {}
    for mode in ("inverse", "factors"):
        fac_fn = jax.jit(lambda a, m=mode: direct.factor_batched(
            a, "cholesky", mode=m))
        fac = fac_fn(A)
        row[mode] = dict(factor_s=timed(fac_fn, A),
                         apply_s=timed(jax.jit(lambda f, x: f.solve(x)),
                                       fac, d))
        del fac
    results["factor_mode"] = row

    # blocked triangular inverse (GPU) vs lax triangular_solve (CPU)
    L = jnp.linalg.cholesky(A)
    eye = jnp.broadcast_to(jnp.eye(n_pad, dtype=A.dtype), A.shape)
    results["triangular_inverse"] = dict(
        blocked_s=timed(jax.jit(direct.batched_tri_lower_inv), L),
        triangular_solve_s=timed(jax.jit(
            lambda l, e: jax.lax.linalg.triangular_solve(
                l, e, left_side=True, lower=True)), L, eye))
    del L, eye

    # fem/subassembly.py: donated in-place jits (GPU) vs eager ops (CPU)
    dmask = jnp.zeros((n_sub, n_pad), bool).at[:, ::7].set(True)
    pou = jnp.asarray(p.pou)
    results["donated_jits"] = dict(
        eliminate_donated_s=timed(
            subassembly._elim_jit2(), fresh=lambda: (A + 0.0, dmask)),
        eliminate_eager_s=timed(
            lambda a, m: subassembly._elim_impl(a, m, None), A, dmask),
        pou_scale_donated_s=timed(
            lambda c, w: subassembly.scale_matrix_with_pou(c, w, donate=True),
            fresh=lambda: (A + 0.0, pou)),
        pou_scale_eager_s=timed(
            lambda c, w: c * w[:, :, None] * w[:, None, :], A, pou))
    del A, d

    # core/sparse.py maybe_tiled_take: tiled gather (GPU) vs plain (CPU), on
    # a general-ELL SpMV (no stencil offsets) of a simplex grid
    from ddm_jax.fem import problems as pm
    from ddm_jax.fem.discretize import Discretization
    from ddm_jax.fem.grids import structured_grid

    disc = Discretization(structured_grid((320, 320), simplex=True),
                          pm.islands())
    ell, _ = disc.assemble()
    ell = dataclasses.replace(ell, offsets=None, fix_rows=None)
    x = jax.random.normal(jax.random.PRNGKey(1), (ell.n,), ell.valsT.dtype)
    row = {"rows": ell.n, "slots": ell.m}
    for name, flag in (("tiled", "1"), ("plain", "0")):
        os.environ["DDM_TILED_GATHER"] = flag  # read when the jit traces
        row[f"{name}_spmv_s"] = timed(jax.jit(lambda a, v: a.mv(v)), ell, x)
    del os.environ["DDM_TILED_GATHER"]
    results["tiled_gather"] = row
    del disc, ell, x

    # end to end: the flagship with one branch flipped at a time
    fac = ("Schwarz", "factorise")
    gevp = ("Eigensolver", "solve GEVP")
    coarse = ("GalerkinPrec", "factor A0")
    results["schwarz_construction"] = dict(
        newton=end_to_end(p, phase=fac),
        direct=end_to_end(
            p, "schwarz.subdomain_solver.construction", "direct", fac))
    results["gevp_precision"] = dict(
        f32=end_to_end(p, phase=gevp),
        f64=end_to_end(p, "geneo_ring.eigensolver.precision", "f64", gevp))
    pt = copy.deepcopy(p.ptree)
    pt["coarse_solver.newton_rtol"] = 1e-6
    pc = dataclasses.replace(p, ptree=pt)
    results["coarse_construction"] = dict(
        newton=end_to_end(pc, phase=coarse),
        direct=end_to_end(pc, "coarse_solver.construction", "direct", coarse))

    for k, v in results.items():
        say(f"{k}: {v}")
    dev = jax.devices()[0]
    say(json.dumps({"device": {"platform": dev.platform,
                               "kind": dev.device_kind,
                               "count": len(jax.devices())},
                    "routes": results}))


if __name__ == "__main__":
    main()
