#!/usr/bin/env python
"""Smoke test on the card: the flagship two-level GenEO-RAS solve through
the public API, plus the checks that only the card can make.

Run from the repository root on a machine with NVIDIA GPUs:

    python chip_smoke.py             # one card
    python chip_smoke.py --chips 4   # the sharded solve over four cards only

One card runs four phases, each of which must pass:

* device     every JAX device is a GPU; prints the card's name and power
             limit as nvidia-smi reports them.
* flagship   bench.py's flagship — 2-D islands Poisson at contrast 1e6,
             384^2 cells (148k dofs), 16x16 = 256 subdomains, overlap 2,
             geneo_ring with nev 8, Cholesky coarse solve, restarted GMRES
             (restart 50) to a reduction of 1e-8 — set up and solved twice
             in this process (cold, then warm) through
             ``api.setup_problem`` / ``build_preconditioner`` / ``solve`` /
             ``solution``.
* factor     one unchunked batched f64 Cholesky of the flagship's
             (256, n_pad, n_pad) subdomain batch, checked per subdomain.
* precision  the double-single products at the flagship's shapes against
             their f64 reference; a TF32 product would fail the bound.

``--chips 4`` runs only the sharded flagship over a four-device mesh
(``build_preconditioner(p, mesh=...)`` + ``solve(p, mesh=...)``) and the
one-card run on device 0 that it is compared with.

Exits non-zero, with no result line, when JAX finds no GPU or any phase
fails.  The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

import argparse
import json
import sys
import time

# The flagship's GMRES iteration count on the CPU route of the same
# pipeline (JAX_PLATFORMS=cpu, where the backend branches take their f64
# routes), measured once: 15.  The card may differ by the summation order
# of f64 scatter-adds and the f32 seeds of its routes.
CPU_ITERATIONS = 15
ITERATION_SLACK = 2
SHARDED_ITERATION_SLACK = 1
TRUE_RESIDUAL_MAX = 2e-8
# Relative distance to scipy's spsolve.  GMRES stops on a 1e-8 reduction of
# the preconditioned residual; at this conditioning that leaves a solution
# error of 1.7e-7 on the CPU route and on the card alike, so the bound
# allows about 6x that and no more.
SPSOLVE_REL_TOL = 1e-6
FACTOR_REL_RESID_MAX = 1e-13
# True f32 accumulation leaves ~1e-6; a TF32 product would read ~1e-3.
DD_REL_ERR_MAX = 1e-5

FLAGSHIP = dict(gridsize=384, parts=16, overlap=2, nev=8)


def say(*args):
    print(*args, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def phase_device(n_chips):
    import jax

    devices = jax.devices()
    if not devices or any(d.platform != "gpu" for d in devices):
        fail(f"no GPU: JAX found {[d.platform for d in devices]}")
    check(len(devices) >= n_chips,
          f"{n_chips} cards asked for, JAX found {len(devices)}")
    import bench

    say(bench.gpu_name_and_power_limit())
    say(f"[device] {len(devices)} x {devices[0].device_kind}, "
        f"jax {jax.__version__}")
    return devices


def build_flagship(gridsize, parts, overlap, nev):
    import jax

    import bench

    t0 = time.perf_counter()
    p = bench.build_problem(gridsize, parts, overlap, nev)
    jax.block_until_ready((p.A.valsT, p.rhs))
    say(f"[flagship] problem: {p.disc.n_dofs} dofs, {p.topo.n_sub} "
        f"subdomains, n_pad {p.topo.n_pad}, host setup "
        f"{time.perf_counter() - t0:.3f} s")
    return p


def run_once(p, mesh=None):
    """build_preconditioner + solve + solution, timed; returns a record."""
    import jax

    from ddm_jax import api

    t0 = time.perf_counter()
    prec = api.build_preconditioner(p, mesh=mesh)
    jax.block_until_ready(prec)
    t1 = time.perf_counter()
    res = api.solve(p, prec=prec, mesh=mesh)
    jax.block_until_ready(res)
    t2 = time.perf_counter()
    u = api.solution(p, res)
    return dict(setup_s=t1 - t0, solve_s=t2 - t1,
                iterations=int(res.iterations),
                converged=bool(res.converged), u=u)


def true_residual(system, u):
    """||A z - rhs|| / ||rhs|| of the unequilibrated constrained system
    ``(A, rhs, g)``, z = u - g."""
    import jax.numpy as jnp

    Ac, rhs, g = system
    return float(jnp.linalg.norm(Ac.mv(u - g) - rhs) / jnp.linalg.norm(rhs))


def check_run(tag, system, run, ref_iterations, slack):
    tr = true_residual(system, run["u"])
    say(f"[{tag}] setup {run['setup_s']:.4f} s, solve {run['solve_s']:.4f} s, "
        f"{run['iterations']} iterations, converged {run['converged']}, "
        f"true relative residual {tr:.3e}")
    check(run["converged"], f"{tag}: GMRES did not converge")
    check(tr <= TRUE_RESIDUAL_MAX,
          f"{tag}: true relative residual {tr:.3e} > {TRUE_RESIDUAL_MAX}")
    check(abs(run["iterations"] - ref_iterations) <= slack,
          f"{tag}: {run['iterations']} iterations, reference "
          f"{ref_iterations} +- {slack}")


def phase_flagship():
    import numpy as np
    import scipy.sparse.linalg as spla

    from ddm_jax import _native
    from ddm_jax.obs.logger import Logger

    Logger.reset()
    p = build_flagship(**FLAGSHIP)
    system = p.disc.constrained_system()
    runs = {}
    for tag in ("cold", "warm"):
        runs[tag] = run_once(p)
        say(f"[flagship] {tag} Logger phases:")
        say(Logger.get().report())
        Logger.reset()
        check_run(f"flagship {tag}", system, runs[tag], CPU_ITERATIONS,
                  ITERATION_SLACK)
    Ac, rhs, g = system
    z_ref = spla.spsolve(p.disc.pattern.to_scipy(Ac).tocsc(), np.asarray(rhs))
    u_ref = np.asarray(g) + z_ref
    u = np.asarray(runs["warm"]["u"])
    err = float(np.linalg.norm(u - u_ref) / np.linalg.norm(u_ref))
    say(f"[flagship] relative distance to spsolve {err:.3e} "
        f"(bound {SPSOLVE_REL_TOL})")
    check(err <= SPSOLVE_REL_TOL, f"solution differs from spsolve by {err}")
    say(f"[flagship] native topology library loaded: "
        f"{_native.load() is not None}")
    return p


def subdomain_batch(p):
    """The flagship's extracted (n_sub, n_pad, n_pad) f64 subdomain batch."""
    import numpy as np

    from ddm_jax.core.indexmaps import extraction_map
    from ddm_jax.core.mesh import batched
    from ddm_jax.precond.extract import extract_subdomain_dense, rect_extract_ok

    topo = p.topo
    rect = getattr(topo, "rect", None)
    local_cols = None
    if not rect_extract_ok(p.A, rect, topo.n_pad):
        local_cols = batched(extraction_map(topo, np.asarray(p.A.colsT).T))
    return extract_subdomain_dense(p.A, batched(topo.sub2glob),
                                   batched(topo.valid), local_cols, rect=rect)


def phase_factor(p):
    import jax.numpy as jnp

    from ddm_jax.solvers.direct import HIGHEST, factor_batched

    A = subdomain_batch(p)
    L = factor_batched(A, "cholesky", mode="factors").chol
    R = jnp.einsum("spq,srq->spr", L, L, precision=HIGHEST) - A
    rel = jnp.linalg.norm(R, axis=(1, 2)) / jnp.linalg.norm(A, axis=(1, 2))
    worst = float(jnp.max(rel))
    say(f"[factor] batch {tuple(A.shape)} {A.dtype}: max per-subdomain "
        f"||L L^T - A||/||A|| = {worst:.3e} (bound {FACTOR_REL_RESID_MAX})")
    check(bool(jnp.isfinite(L).all()), "batched Cholesky is not finite")
    check(worst <= FACTOR_REL_RESID_MAX,
          f"batched Cholesky residual {worst:.3e} > {FACTOR_REL_RESID_MAX}")
    return A.shape


def phase_precision(shape):
    import jax
    import jax.numpy as jnp

    from ddm_jax.solvers.direct import HIGHEST, dd_matmul, dd_matvec, dd_split

    n_sub, n_pad, _ = shape
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    A = jax.random.normal(k1, shape, jnp.float64)
    d = jax.random.normal(k2, (n_sub, n_pad), jnp.float64)
    hi, lo = dd_split(A)

    def rel(y, ref):
        return float(jnp.linalg.norm(y - ref) / jnp.linalg.norm(ref))

    e_mv = rel(dd_matvec(hi, lo, d),
               jnp.einsum("spq,sq->sp", A, d, precision=HIGHEST))
    e_mm = rel(dd_matmul(hi, lo, hi, lo),
               jnp.einsum("spq,sqr->spr", A, A, precision=HIGHEST))
    say(f"[precision] dense {tuple(shape)}: dd_matvec rel err {e_mv:.3e}, "
        f"dd_matmul rel err {e_mm:.3e} (bound {DD_REL_ERR_MAX})")
    check(e_mv <= DD_REL_ERR_MAX, f"dd_matvec rel err {e_mv:.3e}")
    check(e_mm <= DD_REL_ERR_MAX, f"dd_matmul rel err {e_mm:.3e}")


def phase_sharded(n_chips):
    from ddm_jax.core.mesh import subdomain_mesh

    p = build_flagship(**FLAGSHIP)
    system = p.disc.constrained_system()
    single = {}
    for tag in ("cold", "warm"):
        single[tag] = run_once(p)
        check_run(f"one card {tag}", system, single[tag], CPU_ITERATIONS,
                  ITERATION_SLACK)
    mesh = subdomain_mesh(n_chips)
    for tag in ("cold", "warm"):
        run = run_once(p, mesh=mesh)
        check_run(f"{n_chips} cards {tag}", system, run,
                  single[tag]["iterations"], SHARDED_ITERATION_SLACK)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded flagship over four cards")
    args = ap.parse_args(argv)
    devices = phase_device(args.chips)
    if args.chips == 1:
        p = phase_flagship()
        shape = phase_factor(p)
        phase_precision(shape)
    else:
        phase_sharded(args.chips)
    d = devices[0]
    say(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
