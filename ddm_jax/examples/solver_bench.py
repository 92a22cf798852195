"""Direct-solver benchmark (reference: examples/gpu_solvers.cc:20-140).

The reference times UMFPACK vs CHOLMOD vs SuperLU vs STRUMPACK CPU/GPU
factor/solve on a 511^2 P1 Poisson matrix.  The batched analogue compares the
batched dense factorizations this framework actually uses — Cholesky vs QR,
factors-vs-explicit-inverse apply, f64 vs f32 storage — on a batch of
subdomain-sized Poisson blocks, plus scipy SuperLU as the CPU reference
point.

    python -m ddm_jax.examples.solver_bench [-n 512] [-batch 16]
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..config import apply_cli_overrides, ParamTree
from ..solvers.direct import factor_batched


def main(argv=None):
    pt = ParamTree({"n": 512, "batch": 16, "resolves": 50})
    apply_cli_overrides(pt, argv if argv is not None else sys.argv[1:])
    n, batch, resolves = pt.get("n", 512), pt.get("batch", 16), pt.get("resolves", 50)

    # batch of 2D Poisson-like SPD blocks
    rng = np.random.default_rng(0)
    T = np.zeros((n, n))
    i = np.arange(n)
    T[i, i] = 4.0
    T[i[:-1], i[:-1] + 1] = -1.0
    T[i[:-1] + 1, i[:-1]] = -1.0
    A = np.broadcast_to(T, (batch, n, n)).copy()
    A += rng.uniform(0, 0.01, (batch, 1, 1)) * np.eye(n)
    Aj = jnp.asarray(A)
    b = jnp.asarray(rng.normal(size=(batch, n)))

    configs = [
        ("cholesky/factors", dict(solver_type="cholesky", mode="factors")),
        ("cholesky/inverse", dict(solver_type="cholesky", mode="inverse")),
        ("cholesky/inverse-f32", dict(solver_type="cholesky", mode="inverse",
                                      store_dtype=jnp.float32)),
        ("qr/inverse", dict(solver_type="qr", mode="inverse")),
    ]
    print(f"batch={batch} n={n} resolves={resolves} "
          f"backend={jax.default_backend()}")
    for name, kw in configs:
        fac_fn = jax.jit(lambda M, kw=kw: factor_batched(M, **kw))
        try:
            f = fac_fn(Aj)
            jax.block_until_ready(jax.tree_util.tree_leaves(f))
        except Exception as e:
            print(f"{name:>22}: unavailable ({str(e)[:60]})")
            continue
        t0 = time.perf_counter()
        f = fac_fn(Aj)
        jax.block_until_ready(jax.tree_util.tree_leaves(f))
        t_factor = time.perf_counter() - t0
        solve_fn = jax.jit(lambda ff, x: ff.solve(x))
        r = solve_fn(f, b)
        jax.block_until_ready(r)
        t0 = time.perf_counter()
        for _ in range(resolves):
            r = solve_fn(f, r / jnp.linalg.norm(r))
        jax.block_until_ready(r)
        t_solve = (time.perf_counter() - t0) / resolves
        x = solve_fn(f, b)
        resid = float(jnp.abs(jnp.einsum("bij,bj->bi", Aj, x) - b).max())
        print(f"{name:>22}: factor {t_factor*1e3:8.2f} ms   "
              f"resolve {t_solve*1e3:8.3f} ms   resid {resid:.2e}")

    # CPU reference: scipy SuperLU on the sparse equivalent, sequential
    import scipy.sparse as sps
    import scipy.sparse.linalg as spla

    t0 = time.perf_counter()
    lus = [spla.splu(sps.csc_matrix(A[k])) for k in range(batch)]
    t_factor = time.perf_counter() - t0
    bn = np.asarray(b)
    t0 = time.perf_counter()
    for _ in range(resolves):
        for k in range(batch):
            lus[k].solve(bn[k])
    t_solve = (time.perf_counter() - t0) / resolves
    print(f"{'scipy SuperLU (seq)':>22}: factor {t_factor*1e3:8.2f} ms   "
          f"resolve {t_solve*1e3:8.3f} ms")


if __name__ == "__main__":
    main()
