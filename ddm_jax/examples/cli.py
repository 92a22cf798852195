"""Unified example CLI (reference: examples/pdelab_example.cc:29-241):
``-problem {poisson,convection_diffusion,convection_diffusion_dg,
elasticity,nonlinear_poisson}`` + ``-ini_file`` + ``-key value`` overrides.

    python -m ddm_jax.examples.cli -problem poisson -ini_file cfg.ini \
        -coarsespace.type geneo -solver.reduction 1e-10
"""

from __future__ import annotations

import sys


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    problem = "poisson"
    if "-problem" in argv:
        i = argv.index("-problem")
        problem = argv[i + 1]
        del argv[i : i + 2]

    if problem in ("poisson", "convection_diffusion", "islands", "beams"):
        from .poisson import main as m

        if problem == "convection_diffusion":
            argv += ["-problem", "checkerboard_cd"]
        elif problem in ("islands", "beams"):
            argv += ["-problem", problem]
        m(argv)
    elif problem in ("convection_diffusion_dg", "dg"):
        from .convectiondiffusiondg import main as m

        m(argv)
    elif problem in ("elasticity", "linear_elasticity"):
        from .linearelasticity import main as m

        m(argv)
    elif problem in ("nonlinear_poisson", "nonlinear"):
        from .nonlinearpoisson import main as m

        m(argv)
    else:
        raise SystemExit(f"Unknown problem '{problem}'")


if __name__ == "__main__":
    main()
