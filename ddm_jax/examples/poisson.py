"""Poisson / convection-diffusion example driver.

Mirrors the reference's explicit pipeline (examples/poisson.cc:86-408):
grid -> partition -> assembly -> overlap topology -> POU -> fine Schwarz ->
coarse space -> Krylov solve -> VTK output -> timing report, with the same
phase event names ("Setup problem", "Setup preconditioner", "Linear solve",
"Total time", poisson.cc:171-174) and config keys.

Run:  python -m ddm_jax.examples.poisson -ini_file cfg.ini [-key value ...]
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np

from ..api import (
    build_preconditioner,
    default_ptree,
    setup_problem,
    solution,
    solve,
)
from ..config import ParamTree, apply_cli_overrides, read_ini_file
from ..fem import problems as pm
from ..obs.logger import Logger, logger, scoped, setup_loggers


def run(ptree: ParamTree, problem=None):
    Logger.reset()
    total = scoped("Total", "total time")
    Logger.get().start_event(total.event)

    with scoped("Driver", "Setup problem"):
        p = setup_problem(ptree, problem=problem)
        jax.block_until_ready(p.A.valsT)

    with scoped("Driver", "Setup preconditioner"):
        prec = build_preconditioner(p)
        jax.block_until_ready(jax.tree_util.tree_leaves(prec))

    with scoped("Driver", "Linear solve"):
        res = solve(p, prec)
        jax.block_until_ready(res.x)

    logger.info(
        "Solved in {} iterations (converged: {}), defect {} -> {}",
        int(res.iterations), bool(res.converged), float(res.defect0),
        float(res.defect),
    )

    if ptree.get("visualise", False):
        with scoped("Driver", "Visualisation"):
            visualise(p, res, ptree.get("vtk_filename", "poisson_out.vtu"),
                      prec=prec)

    Logger.get().end_event(total.event)
    Logger.get().report(stream=sys.stderr)
    return p, res


def visualise(p, res, filename: str, prec=None):
    """Solution + DDM debug fields (reference: poisson.cc:324-386).

    Beyond the global fields (solution, RHS, POU partition sum, owner map,
    element partition), this writes the debug-subdomain fields the reference
    scopes to ``debug_rank``: that subdomain's POU weights and overlap
    indicator (poisson.cc:360-366), every coarse-basis vector of the debug
    subdomain as ``basis_vec_NNNN`` (poisson.cc:369-379), and the ring
    region used by ring coarse spaces — all zero otherwise, exactly as the
    reference's "might be all zero for non-ring" note (poisson.cc:381-386).
    """
    from ..fem.vtk import write_vtu

    u = solution(p, res)
    n = p.disc.n_dofs
    topo = p.topo

    def scatter_sub(k, vals):
        """Scatter subdomain k's padded local vector to a global field."""
        out = np.zeros(n + 1)
        valid = np.asarray(topo.valid[k])
        np.add.at(out, np.asarray(topo.sub2glob[k]),
                  np.where(valid, np.asarray(vals), 0.0))
        return out[:n]

    pou_sum = np.zeros(n + 1)
    np.add.at(pou_sum, p.topo.sub2glob, p.pou)
    owner = np.zeros(n + 1)
    np.add.at(owner, p.topo.sub2glob,
              p.topo.owner * (np.arange(p.topo.n_sub)[:, None] + 1.0))

    dbg = int(p.ptree.get("debug_rank", 0))
    if dbg > topo.n_sub - 1:
        dbg = 0  # same clamping as poisson.cc:333-334
    point_data = {
        "solution": np.asarray(u),
        # un-equilibrated RHS (setup_problem scales rhs' = scale * rhs)
        "rhs": np.asarray(p.rhs if p.scale is None else p.rhs / p.scale),
        "pou_sum": pou_sum[:n],
        "owner_subdomain": owner[:n] - 1,
        "pou": scatter_sub(dbg, p.pou[dbg]),
        "ovlp_subdomain": scatter_sub(dbg, np.ones(topo.n_pad)),
    }

    # coarse-basis vectors of the debug subdomain (poisson.cc:369-379)
    coarse = None
    if prec is not None:
        precs = getattr(prec, "precs", (prec,))
        coarse = next((q for q in precs if hasattr(q, "V")), None)
    if coarse is not None:
        V = np.asarray(coarse.V[dbg])  # (nev_max, n_pad)
        active = np.asarray(coarse.active[dbg])
        for k in range(V.shape[0]):
            if active[k]:
                point_data[f"basis_vec_{k:04d}"] = scatter_sub(dbg, V[k])

    # ring region (poisson.cc:381-386; all-zero for non-ring coarse spaces)
    cs_type = p.ptree.sub("coarsespace").get("type", "none")
    if cs_type.endswith("_ring"):
        ring = np.asarray(topo.valid[dbg] &
                          (topo.bdist[dbg] <= 2 * topo.overlap + 1))
        point_data["ring_region"] = scatter_sub(dbg, ring.astype(np.float64))
    else:
        point_data["ring_region"] = np.zeros(n)

    cell_data = {"partition": np.asarray(p.elem_part, dtype=np.float64)}
    write_vtu(filename, p.disc.grid, point_data, cell_data)
    logger.info("Wrote {}", filename)


def main(argv=None):
    argv = setup_loggers(argv if argv is not None else sys.argv[1:])
    ptree = default_ptree()
    # defaults akin to examples/poisson.ini
    ptree["gridsize"] = 64
    ptree["subdomains"] = 16
    rest = apply_cli_overrides(ptree, argv)
    ini = ptree.get("ini_file", "")
    if ini:
        read_ini_file(ini, ptree)
        apply_cli_overrides(ptree, argv)  # CLI wins over ini
    coeff_file = ptree.get("coefficient_file", "")
    if coeff_file:
        from ..fem.scripted import load_problem

        problem = load_problem(coeff_file)
    else:
        problem_name = ptree.get("problem", "simple")
        problem = pm.PROBLEMS[problem_name]()
    run(ptree, problem)


if __name__ == "__main__":
    main()
