"""The bench's CPU baselines must agree with each other: the parallel
(multiprocessing, MPI-rank-emulating) baseline is the honest comparison the
benchmark reports against on multi-core hosts (bench.py:run_cpu_baseline_parallel),
and single-core bench hosts never execute it — so it is pinned here on a tiny
problem with 2 workers against the sequential baseline.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.slow
def test_parallel_cpu_baseline_matches_sequential():
    import bench

    p = bench.build_problem(gridsize=24, parts=2, overlap=2, nev=2)
    seq = bench.run_cpu_baseline(p, nev=2)
    par = bench.run_cpu_baseline_parallel(p, nev=2, n_workers=2)
    assert par["converged"] and seq["converged"]
    # identical algebra, different summation grouping: allow 1 iter of slack
    assert abs(par["iters"] - seq["iters"]) <= 1
    assert par["true_rel_res"] < 1e-7
