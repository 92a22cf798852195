#!/usr/bin/env python
"""Benchmark: two-level GenEO-RAS on heterogeneous Poisson.

Runs on a GPU only: it exits non-zero when JAX finds no GPU.  Prints the
card's name and power limit on one line, then ONE JSON line:
  {"metric": ..., "value": N, "unit": "s", "vs_baseline": N, "device": ...}

value       = device wall-clock for the FULL preconditioner setup (subdomain
              extraction + factorization + Neumann assembly + batched GenEO
              eigensolves + coarse matrix + coarse factorization) + the
              GMRES solve to 1e-8, steady state (second run; compile
              excluded — the reference has no JIT either).
vs_baseline = cpu_reference_seconds / device_seconds.  The CPU baseline runs
              the *reference's algorithm* on host: per-subdomain sparse LU
              (SuperLU = UMFPACK-class) + per-subdomain dense GEVPs (LAPACK,
              same congruence-transform math as the device path — scipy's
              shift-invert eigsh produced a qualitatively worse basis),
              executed sequentially as the per-rank code would, + scipy
              GMRES with sequential two-level applies.  dune-ddm publishes
              no numbers of its own, so this emulation is the baseline.

Config via env: DDM_BENCH_GRIDSIZE (384), DDM_BENCH_PARTS (16 -> 256
subdomains), DDM_BENCH_OVERLAP (2), DDM_BENCH_NEV (8).
"""

import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def build_problem(gridsize, parts, overlap, nev, dim=2):
    from ddm_jax.api import default_ptree, setup_problem
    from ddm_jax.fem import problems as pm
    from ddm_jax.fem.grids import structured_grid

    pt = default_ptree()
    pt["gridsize"] = gridsize
    pt["overlap"] = overlap
    pt["solver.reduction"] = 1e-8
    # DDM_BENCH_COARSE switches the coarse space (geneo / geneo_ring /
    # msgfem_ring / ...).  Headline default is geneo_ring — the reference
    # built the ring spaces exactly to cut setup cost (coarse_spaces.hh:
    # 502-648), and at bench scale it converges in FEWER iterations than
    # full GenEO here (15 vs 17).  The CPU reference baseline keeps
    # emulating the reference's default full-GenEO algorithm, so the
    # comparison stays
    # reference-default vs our best config; set DDM_BENCH_COARSE=geneo for
    # the like-for-like algorithm comparison.
    # Second bench pipeline: DDM_BENCH_PROBLEM=elasticity
    # runs the vector-valued steel-rubber config (reference:
    # linearelasticity.cc:27-159) at >=100k dofs — exercises the vector
    # (n_comp=2) canvas, the elasticity assembler and the rigid-body-mode
    # GEVP at scale.  The reference drives elasticity with full GenEO, so
    # the elasticity default coarse space is geneo (still overridable).
    problem_kind = os.environ.get("DDM_BENCH_PROBLEM", "poisson")
    cs = os.environ.get(
        "DDM_BENCH_COARSE",
        "geneo" if problem_kind == "elasticity" else "geneo_ring")
    pt["coarsespace.type"] = cs
    if problem_kind == "elasticity":
        # elasticity's two-level M is norm-distorting (~1e5 at the
        # 2e11/2e7 stiffness contrast): left-preconditioned GMRES
        # honestly reduces ||M r|| by 1e-8 while the TRUE residual floors
        # at ~5e-4 — measured against scipy with the SAME M (55 its to the
        # same ||M r||, true 6.6e-9, just a longer Krylov path).  The
        # flexible (right-preconditioned) solver terminates on the true
        # residual (ISTL RestartedFlexibleGMResSolver semantics): measured
        # 47 its / true 8.8e-9 at 64^2.
        pt["solver.type"] = "restartedflexiblegmressolver"
    pt["coarse_solver.type"] = "cholesky"
    pt[f"{cs}.eigensolver.nev"] = nev
    # Precision mode: f64 (default) runs the f64 apply path and
    # terminates on the standard ISTL estimate.  DDM_BENCH_PRECISION=dd
    # switches to double-single applies + dd orthogonalization with
    # verified termination — honest 1e-8 at ~1.6-2x the iterations on
    # SMALL problems, but measured non-convergent (stalls ~2e-3) at
    # 384^2/contrast 1e6: the dd apply noise floor exceeds what verified
    # GMRES can push through at this conditioning.  Kept opt-in for
    # moderate-tolerance / moderate-contrast runs only.
    prec = os.environ.get("DDM_BENCH_PRECISION", "f64")
    if prec != "f64":
        pt["schwarz.subdomain_solver.precision"] = prec
        pt["coarse_solver.precision"] = prec
    pt["solver.ortho"] = os.environ.get("DDM_BENCH_ORTHO", "f64")
    # Preconditioner-grade Newton stop for the fine explicit inverses: at
    # bench scale (islands 384^2/256, contrast 1e6) rtol 4e-1 / 2e-2 / 1e-6
    # all give the SAME 15 GMRES iterations and true rel. residual 1.52e-8 —
    # Newton error is multiplicative, X = A^{-1}(I+E), so a rough inverse
    # rescales the preconditioned spectrum without perturbing the
    # small-eigenvalue structure (unlike the failed additive f32 apply
    # path) — with fewer Newton steps.  The ring extension's reuse of this inverse
    # is residual-VERIFIED with a direct fallback (coarse/ring.py), so the
    # looser stop can cost wall-clock but never correctness.  Library
    # default stays exact-grade 1e-6 (reference parity: exact UMFPACK
    # subdomain solves); the bench opts in explicitly, like choosing the
    # ring coarse space.  Override via DDM_BENCH_SET=...newton_rtol=1e-6.
    pt["schwarz.subdomain_solver.newton_rtol"] = 4e-1
    # extension PCG: 4 f64 polish iterations at accept 1e-6 give the same
    # GMRES iteration count as the 16/1e-8 library default with less
    # work; the residual-verified escalation chain still covers
    # pathological pencils.  Skipping the f64 polish outright is slower
    # (the f32 floor misses 2e-5 on some vectors -> escalation to the
    # 40-iteration fallback).
    pt["geneo_ring.extension.maxit64"] = 4
    pt["geneo_ring.extension.tolerance"] = 1e-6
    # Generic sweep knob: DDM_BENCH_SET="key=val,key=val" applies raw ptree
    # overrides after all of the above (ints/floats auto-parsed) — lets perf
    # sweeps vary any config (e.g. geneo_ring.eigensolver.refine_iters)
    # without editing this file.
    for kv in filter(None, os.environ.get("DDM_BENCH_SET", "").split(",")):
        k, _, v = kv.partition("=")
        for cast in (int, float, str):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        log(f"override: {k} = {v!r}")
        pt[k.strip()] = v
    if dim == 3:
        # memory-tight: each (512, 1000, 1000) f64 batch is 4.1 GB; 24 is
        # the slab size that fit a 16 GB device, not yet measured on an
        # 80 GB card (ROADMAP B7)
        os.environ.setdefault("DDM_BATCH_CHUNK", "24")
    # DDM_BENCH_DIM=3 runs the 3-D hex analogue of the flagship
    # (3-D GenEO-RAS, reference poisson.ini): same islands coefficient
    # (x,y-dependent, z-extruded), 27-point stencil ELL, N-D box canvas
    # (core/boxnd.py) for the extraction/gather/scatter fast paths
    if problem_kind == "elasticity":
        extent = (3.0, 1.0) if dim == 2 else (3.0, 1.0, 1.5)
        grid = structured_grid((gridsize,) * dim, (0,) * dim, extent)
        prob = (pm.steel_rubber_2d() if dim == 2
                else pm.steel_rubber_bar())
        return setup_problem(pt, problem=prob, grid=grid,
                             parts=(parts,) * dim, n_comp=dim)
    grid = structured_grid((gridsize,) * dim)
    return setup_problem(pt, problem=pm.islands(), grid=grid,
                         parts=(parts,) * dim)


def run_device(p, nev, attempts=None, tag=""):
    if attempts is None:
        # DDM_BENCH_ATTEMPTS=1 for memory-tight configs; a SECOND bench
        # process is then the warm measurement — the persistent compile
        # cache makes its compiles warm while device memory starts fresh
        attempts = max(1, int(os.environ.get("DDM_BENCH_ATTEMPTS", "2")))
    import jax
    import jax.numpy as jnp

    from ddm_jax.api import build_preconditioner
    from ddm_jax.solvers.krylov import gmres_solve, operator_of, prec_of

    timings = {}
    all_timings = []
    prec = res = None
    for attempt in range(attempts):
        # free the previous attempt's preconditioner BEFORE rebuilding: at
        # bench scale the old explicit inverses (~1.5 GB) pushed the second
        # build of memory-heavier coarse spaces (geneo_ring) over a 16 GB
        # device's memory
        prec = res = None
        import gc

        gc.collect()
        t0 = time.perf_counter()
        prec = build_preconditioner(p)
        jax.block_until_ready(jax.tree_util.tree_leaves(prec))
        t1 = time.perf_counter()
        dd_any = (p.ptree.sub("schwarz").sub("subdomain_solver")
                  .get("precision", "f64") != "f64")
        from ddm_jax.solvers.krylov import fgmres_solve

        st = p.ptree.get("solver.type", "restartedgmressolver").lower()
        solve_fn = (fgmres_solve
                    if st in ("restartedflexiblegmressolver", "fgmres")
                    else gmres_solve)
        res = solve_fn(
            operator_of(p.A), prec_of(prec), p.rhs, jnp.zeros_like(p.rhs),
            reduction=1e-8, maxit=400, restart=50,
            ortho=p.ptree.get("solver.ortho", "f64"),
            # reduced-precision applies decouple the Givens estimate from
            # the true residual — always terminate on the verified defect
            verify=True if dd_any else None,
        )
        jax.block_until_ready(res.x)
        t2 = time.perf_counter()
        true_res = float(jnp.linalg.norm(p.A.mv(res.x) - p.rhs)
                         / jnp.linalg.norm(p.rhs))
        timings = {
            "setup": t1 - t0, "solve": t2 - t1,
            "iters": int(res.iterations), "converged": bool(res.converged),
            "true_rel_res": true_res,
        }
        all_timings.append(timings)
        log(f"device{tag} attempt {attempt}: {timings}")
    from ddm_jax.obs.logger import Logger

    log(Logger.get().report())
    timings["cold"] = dict(all_timings[0])
    return timings


def _worker_main(conn, Asp, b_unused, sub_ids, sub_pou, A_neu_k, C_k, nev):
    """One baseline worker = a chunk of 'MPI ranks': factor its subdomains,
    solve its GEVPs, then serve preconditioner applies.  Mirrors the
    reference's per-rank code (schwarz.hh solve + coarse restriction dots)."""
    import numpy as np
    import scipy.linalg as sla
    import scipy.sparse.linalg as spla

    t0 = time.perf_counter()
    lus = [spla.splu(Asp[ids][:, ids].tocsc()) for ids in sub_ids]
    t_factor = time.perf_counter() - t0

    t0 = time.perf_counter()
    W = []
    for k in range(len(sub_ids)):
        Ak, Ck = A_neu_k[k], C_k[k]
        eps = 1e-12 * max(np.abs(np.diag(Ak)).mean(), 1.0)
        L = np.linalg.cholesky(Ak + eps * np.eye(Ak.shape[0]))
        Linv = sla.solve_triangular(L, np.eye(Ak.shape[0]), lower=True)
        S = Linv @ Ck @ Linv.T
        mu, Wk = np.linalg.eigh(0.5 * (S + S.T))
        vecs = Linv.T @ Wk[:, -nev:][:, ::-1]
        w = sub_pou[k][:, None] * vecs
        w = w / np.maximum(np.linalg.norm(w, axis=0), 1e-300)
        W.append(w)
    t_eig = time.perf_counter() - t0
    conn.send(("setup", t_factor, t_eig))

    while True:
        msg = conn.recv()
        if msg[0] == "apply":
            d = msg[1]
            n = d.shape[0]
            x = np.zeros(n)
            alpha = np.empty((len(sub_ids), nev))
            for k, ids in enumerate(sub_ids):
                dk = d[ids]
                x[ids] += sub_pou[k] * lus[k].solve(dk)
                alpha[k] = W[k].T @ dk
            conn.send((x, alpha))
        elif msg[0] == "prolong":
            beta = msg[1]
            n = msg[2]
            x = np.zeros(n)
            for k, ids in enumerate(sub_ids):
                x[ids] += W[k] @ beta[k]
            conn.send(x)
        elif msg[0] == "basis":
            conn.send([(ids, w) for ids, w in zip(sub_ids, W)])
        else:
            return



def _baseline_gevp_mats(p):
    """Host numpy (A_neu, C) for the CPU baselines, computed ONCE right
    after the problem build, while device memory is empty (the 3-D bench
    ran out of memory on a 16 GB device when they were recomputed after the
    device attempts).  Cached on the problem object."""
    cached = getattr(p, "_baseline_mats", None)
    if cached is not None:
        return cached
    import jax.numpy as jnp
    from ddm_jax.coarse.geneo import neumann_matrices
    from ddm_jax.fem.subassembly import scale_matrix_with_pou

    A_neu_d, B_neu_d = neumann_matrices(p)
    # download A first, then donate B into the POU scaling: at 3-D bench
    # scale a non-donated scale would hold 4 batch-sized buffers (r4 OOM)
    A_neu = np.asarray(A_neu_d.reshape(-1)).reshape(A_neu_d.shape)
    del A_neu_d
    C_d = scale_matrix_with_pou(B_neu_d, jnp.asarray(p.pou), donate=True)
    del B_neu_d
    C = np.asarray(C_d.reshape(-1)).reshape(C_d.shape)
    mats = (A_neu, C)
    object.__setattr__(p, "_baseline_mats", mats)
    return mats


def run_cpu_baseline_parallel(p, nev, n_workers=None):
    """The reference's deployment model emulated honestly: subdomain work
    (factorization, GEVPs, per-iteration solves + coarse dots) distributed
    over worker PROCESSES like MPI ranks; the coarse solve serialized on the
    master like the reference's rank-0 solve
    (galerkin_preconditioner.hh:171-183)."""
    import multiprocessing as mp

    import scipy.sparse as sps
    import scipy.sparse.linalg as spla

    import jax.numpy as jnp
    from ddm_jax.coarse.geneo import neumann_matrices
    from ddm_jax.fem.subassembly import scale_matrix_with_pou

    if n_workers is None:
        n_workers = min(os.cpu_count() or 1, p.topo.n_sub)
    Asp = p.disc.pattern.to_scipy(p.A).tocsc()
    b = np.asarray(p.rhs)
    topo = p.topo
    n = Asp.shape[0]

    A_neu, C = _baseline_gevp_mats(p)

    # chunk subdomains over workers.  The workers are spawned, never forked
    # from this process, which has the device open; they need only numpy and
    # scipy, and run with JAX held to the CPU should anything import it.
    chunks = np.array_split(np.arange(topo.n_sub), n_workers)
    ctx = mp.get_context("spawn")
    conns, procs = [], []
    t_wall0 = time.perf_counter()
    saved_platforms = os.environ.get("JAX_PLATFORMS")
    os.environ["JAX_PLATFORMS"] = "cpu"  # inherited by the spawned workers
    try:
        for ch in chunks:
            sub_ids, sub_pou, An_k, C_k = [], [], [], []
            for k in ch:
                loc = np.nonzero(topo.valid[k])[0]
                ids = topo.sub2glob[k, loc].astype(np.int64)
                sub_ids.append(ids)
                sub_pou.append(np.asarray(p.pou[k, loc]))
                An_k.append(A_neu[k][np.ix_(loc, loc)])
                C_k.append(C[k][np.ix_(loc, loc)])
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_worker_main,
                args=(child, Asp, None, sub_ids, sub_pou, An_k, C_k, nev),
            )
            proc.start()
            conns.append(parent)
            procs.append(proc)
    finally:
        if saved_platforms is None:
            del os.environ["JAX_PLATFORMS"]
        else:
            os.environ["JAX_PLATFORMS"] = saved_platforms
    setup_times = [c.recv() for c in conns]
    t_setup_wall = time.perf_counter() - t_wall0

    # coarse matrix on master (rank-0 style)
    t0 = time.perf_counter()
    basis = []
    for c in conns:
        c.send(("basis",))
    for c in conns:
        basis.extend(c.recv())
    nc = topo.n_sub * nev
    R = sps.lil_matrix((nc, n))
    for k, (ids, w) in enumerate(basis):
        for j in range(nev):
            R[k * nev + j, ids] = w[:, j]
    R = R.tocsr()
    E = (R @ Asp @ R.T).toarray()
    from scipy.linalg import lu_factor, lu_solve

    Elu = lu_factor(E)
    t_coarse = time.perf_counter() - t0

    def prec_apply(d):
        for c in conns:
            c.send(("apply", d))
        x = np.zeros(n)
        alphas = []
        for c in conns:
            xk, ak = c.recv()
            x += xk
            alphas.append(ak)
        alpha = np.concatenate(alphas).reshape(-1)
        beta = lu_solve(Elu, alpha).reshape(topo.n_sub, nev)
        bsplit = np.array_split(beta, n_workers)
        for c, bk in zip(conns, bsplit):
            c.send(("prolong", bk, n))
        for c in conns:
            x += c.recv()
        return x

    M = spla.LinearOperator((n, n), matvec=prec_apply)
    it = [0]
    t0 = time.perf_counter()
    x, info = spla.gmres(Asp, b, rtol=1e-8, atol=0.0, restart=50,
                         maxiter=400, M=M,
                         callback=lambda *_: it.__setitem__(0, it[0] + 1),
                         callback_type="pr_norm")
    t_solve = time.perf_counter() - t0
    for c in conns:
        c.send(("quit",))
    for pr in procs:
        pr.join(timeout=10)
    out = {
        "workers": n_workers,
        "setup": t_setup_wall + t_coarse,
        "coarse": t_coarse,
        "solve": t_solve,
        "iters": it[0],
        "converged": info == 0,
        "true_rel_res": float(np.linalg.norm(Asp @ x - b)
                              / np.linalg.norm(b)),
    }
    log(f"cpu parallel baseline ({n_workers} workers): {out}")
    return out


def run_cpu_baseline(p, nev):
    import scipy.sparse as sps
    import scipy.sparse.linalg as spla

    import jax.numpy as jnp
    from ddm_jax.coarse.geneo import neumann_matrices
    from ddm_jax.fem.subassembly import scale_matrix_with_pou

    Asp = p.disc.pattern.to_scipy(p.A).tocsc()
    b = np.asarray(p.rhs)
    topo = p.topo
    n = Asp.shape[0]

    # Neumann matrices: reuse the (device-assembled) element sums; the
    # reference assembles these during FEM assembly, so their cost is not
    # charged to either side.
    A_neu, C = _baseline_gevp_mats(p)

    t0 = time.perf_counter()
    lus, subids, pou_rows = [], [], []
    for k in range(topo.n_sub):
        ids = topo.sub2glob[k, topo.valid[k]].astype(np.int64)
        subids.append(ids)
        pou_rows.append(np.asarray(p.pou[k, topo.valid[k]]))
        lus.append(spla.splu(Asp[ids][:, ids].tocsc()))
    t_factor = time.perf_counter() - t0

    # Per-subdomain GEVPs, solved SEQUENTIALLY as the reference's per-rank
    # architecture does.  Using the same dense congruence-transform math as
    # the device path (LAPACK quality) rather than scipy's shift-invert eigsh:
    # eigsh's Lanczos basis produces a measurably worse coarse space here
    # (at 384^2/256 subdomains its GMRES never converged), which would make
    # the baseline look artificially slow.  This keeps the comparison pure
    # sequential-CPU vs batched-device on identical algorithms.
    import scipy.linalg as sla

    t0 = time.perf_counter()
    basis_rows = []
    for k in range(topo.n_sub):
        loc = np.nonzero(topo.valid[k])[0]  # local positions in the padded
        Ak = A_neu[k][np.ix_(loc, loc)]     # dense blocks; the j-th valid
        Ck = C[k][np.ix_(loc, loc)]         # slot is global dof subids[k][j]
        eps = 1e-12 * max(np.abs(np.diag(Ak)).mean(), 1.0)
        L = np.linalg.cholesky(Ak + eps * np.eye(loc.size))
        Linv = sla.solve_triangular(L, np.eye(loc.size), lower=True)
        S = Linv @ Ck @ Linv.T
        mu, W = np.linalg.eigh(0.5 * (S + S.T))
        Wm = W[:, -nev:][:, ::-1]
        vecs = Linv.T @ Wm
        w = pou_rows[k][:, None] * vecs
        w = w / np.maximum(np.linalg.norm(w, axis=0), 1e-300)
        basis_rows.append((subids[k], w))
    t_eig = time.perf_counter() - t0

    # coarse matrix + factorization
    t0 = time.perf_counter()
    nc = topo.n_sub * nev
    R = sps.lil_matrix((nc, n))
    for k, (ids, w) in enumerate(basis_rows):
        for j in range(nev):
            R[k * nev + j, ids] = w[:, j]
    R = R.tocsr()
    E = (R @ Asp @ R.T).toarray()
    from scipy.linalg import lu_factor, lu_solve

    Elu = lu_factor(E)
    t_coarse = time.perf_counter() - t0

    def prec_apply(d):
        x = np.zeros(n)
        for k in range(topo.n_sub):
            x[subids[k]] += pou_rows[k] * lus[k].solve(d[subids[k]])
        alpha = R @ d
        x += R.T @ lu_solve(Elu, alpha)
        return x

    M = spla.LinearOperator((n, n), matvec=prec_apply)
    it = [0]
    t0 = time.perf_counter()
    x, info = spla.gmres(Asp, b, rtol=1e-8, atol=0.0, restart=50,
                         maxiter=400, M=M, callback=lambda *_: it.__setitem__(0, it[0] + 1),
                         callback_type="pr_norm")
    t_solve = time.perf_counter() - t0
    out = {
        "factor": t_factor, "eig": t_eig, "coarse": t_coarse,
        "solve": t_solve, "iters": it[0], "converged": info == 0,
        "setup": t_factor + t_eig + t_coarse,
        # both sides terminate on the ISTL-style PRECONDITIONED defect; the
        # unpreconditioned truth makes norm-distorted problems (elasticity)
        # comparable honestly
        "true_rel_res": float(np.linalg.norm(Asp @ x - b)
                              / np.linalg.norm(b)),
    }
    log(f"cpu baseline: {out}")
    return out


def main():
    import jax

    if jax.default_backend() != "gpu":
        log(f"bench.py needs a GPU; JAX found {jax.default_backend()!r}")
        sys.exit(1)
    print(gpu_name_and_power_limit(), flush=True)
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    dim = int(os.environ.get("DDM_BENCH_DIM", "2"))
    problem_kind = os.environ.get("DDM_BENCH_PROBLEM", "poisson")
    # elasticity default 256^2 x 2 comps = 132k dofs: same n_pad class as
    # the Poisson headline (tile 21 x 42 -> 882) at 256 subdomains
    grid_default = "384" if dim == 2 else "56"
    if problem_kind == "elasticity":
        grid_default = "256" if dim == 2 else "40"
    gridsize = int(os.environ.get("DDM_BENCH_GRIDSIZE", grid_default))
    parts = int(os.environ.get("DDM_BENCH_PARTS", "16" if dim == 2 else "8"))
    overlap = int(os.environ.get("DDM_BENCH_OVERLAP", "2"))
    nev = int(os.environ.get("DDM_BENCH_NEV", "8"))

    t0 = time.perf_counter()
    p = build_problem(gridsize, parts, overlap, nev, dim=dim)
    host_setup_s = time.perf_counter() - t0
    # the CPU baselines' GEVP matrices download now, while device memory is
    # empty (not charged to either side — the reference assembles them
    # during FEM assembly)
    _baseline_gevp_mats(p)
    log(f"host setup: {host_setup_s:.3f}s; n={p.disc.n_dofs} "
        f"n_sub={p.topo.n_sub} n_pad={p.topo.n_pad}")

    dev_run = run_device(p, nev)

    # like-for-like algorithm comparison: when the headline coarse space
    # differs from the CPU baseline's full-GenEO algorithm, ALSO time a
    # geneo preconditioner on the SAME problem so the JSON artifact carries
    # both ratios (reference-default-vs-our-best AND algorithm-for-algorithm)
    dev_geneo = None
    cs = os.environ.get(
        "DDM_BENCH_COARSE",
        "geneo" if problem_kind == "elasticity" else "geneo_ring")
    if cs != "geneo" and os.environ.get("DDM_BENCH_LIKE4LIKE", "1") != "0":
        import copy
        import dataclasses
        import gc

        gc.collect()
        pt2 = copy.deepcopy(p.ptree)
        pt2["coarsespace.type"] = "geneo"
        pt2["geneo.eigensolver.nev"] = nev
        p2 = dataclasses.replace(p, ptree=pt2)
        dev_geneo = run_device(p2, nev, tag=" geneo")
        del p2
        gc.collect()
    cpu_totals = {}
    parallel_note = None
    if (os.cpu_count() or 1) > 1:
        cpu_par = run_cpu_baseline_parallel(p, nev)
        cpu_totals["parallel"] = (cpu_par["setup"] + cpu_par["solve"],
                                  f"{cpu_par['workers']} workers")
    else:
        # the honest MPI-emulating comparison can't run here; say so in the
        # JSON instead of silently reporting only the sequential number
        # (the parallel path itself is pinned by tests/test_bench_baselines.py)
        parallel_note = "skipped: 1 core"
    cpu_seq = run_cpu_baseline(p, nev)
    cpu_totals["sequential"] = (cpu_seq["setup"] + cpu_seq["solve"], "1 core")

    dev_total = dev_run["setup"] + dev_run["solve"]
    log(f"device {dev_total:.2f}s | " + " | ".join(
        f"CPU {k} ({d}) {t:.2f}s ({t / dev_total:.2f}x)"
        for k, (t, d) in cpu_totals.items()))
    # vs_baseline reports against the BEST CPU deployment available on this
    # host: the parallel (MPI-emulating) baseline when the host has multiple
    # cores, else the plain sequential run (a 1-worker "parallel" baseline
    # only measures IPC overhead and would inflate the ratio).
    best_cpu = min(t for t, _ in cpu_totals.values())
    cold = dev_run.get("cold", dev_run)
    metric_head = ("elasticity_steel_rubber_geneo_ras"
                   if problem_kind == "elasticity"
                   else "poisson_islands_geneo_ras")
    out = {
        "metric": f"{metric_head}_"
                  f"{'x'.join([str(gridsize)] * dim)}_"
                  f"{parts ** dim}sub_setup_solve",
        "value": round(dev_total, 4),
        "unit": "s",
        "vs_baseline": round(best_cpu / dev_total, 3),
        # honesty: the warm headline excludes one-time costs the reference
        # does not have — report them in the same artifact.  cold_total_s is
        # the full first-run wall-clock (host-side problem build incl. any
        # cold compiles + first preconditioner build + first solve).
        "host_setup_s": round(host_setup_s, 2),
        "cold_total_s": round(
            host_setup_s + cold["setup"] + cold["solve"], 2),
        "cpu_sequential_s": round(cpu_totals["sequential"][0], 2),
        "device": device,
    }
    if dev_geneo is not None:
        # like-for-like: both sides run the full-GenEO algorithm
        g_total = dev_geneo["setup"] + dev_geneo["solve"]
        out["geneo_s"] = round(g_total, 4)
        out["vs_baseline_geneo"] = round(best_cpu / g_total, 3)
        out["iters_geneo"] = dev_geneo["iters"]
    if parallel_note:
        out["cpu_parallel_baseline"] = parallel_note
    print(json.dumps(out))


if __name__ == "__main__":
    main()
