"""Eigensolver subsystem: batched dense GEVP + batched LOBPCG, dispatched
by config like the reference's solve_gevp (dune/ddm/eigensolvers/
eigensolvers.hh:14-38 — there only Type::Spectra is implemented; the
"KrylovSchur" type its configs reference maps to the iterative path here)."""

from .dense_gevp import (  # noqa: F401
    solve_gevp_dense,
    solve_gevp_dense_auto,
    solve_gevp_dense_jit,
)
from .params import EigensolverParams  # noqa: F401

_DENSE_NAMES = {"spectra", "dense"}
_ITERATIVE_NAMES = {"krylovschur", "lobpcg", "lanczos", "blocklanczos"}

# Dense/iterative crossover for eigensolver.type=auto, in subdomain size p:
# LOBPCG's ~linear-in-p iteration cost takes over as the dense solver's
# O(p^3) dominates.  Tuned on the first accelerator and not yet measured on
# the GPU (ROADMAP A3).
AUTO_CROSSOVER_P = 2048


def solve_gevp(A, C, params: EigensolverParams, spd: bool = True,
               prec_inv=None):
    """Solve the batched pencil A v = lambda C v, keeping the smallest
    eigenpairs per ``params`` — the config-dispatched entry
    (``eigensolver.type``).  Returns (lam, V, active) with the static
    (n_sub, params.max_kept) layout of both backends.

    * ``spectra``/``dense``: the congruence-transform dense solver —
      deterministic full spectrum, the default (dense_gevp.py).
    * ``krylovschur``/``lobpcg``/``lanczos``: batched LOBPCG with the
      reference's adaptive nev/threshold escalation (lobpcg.py) — for
      subdomains large enough that the O(p^3) eigh dominates.  spd=False
      pencils (indefinite DG Neumann sums) must use the dense path.
    * ``auto``: dense for p <= AUTO_CROSSOVER_P or non-SPD pencils, else
      LOBPCG (a tuned crossover; no reference analogue — its
      Spectra path is the only one implemented, eigensolvers.hh:14-38).
    """
    t = params.type.lower()
    if t == "auto":
        p = A.shape[-1]
        t = "spectra" if (p <= AUTO_CROSSOVER_P or not spd) else "lobpcg"
    if t in _DENSE_NAMES:
        return solve_gevp_dense_auto(A, C, params, spd=spd)
    if t in _ITERATIVE_NAMES:
        if not spd:
            raise ValueError(
                "the iterative eigensolver requires an SPD pencil; "
                "indefinite problems must use eigensolver.type=spectra"
            )
        from .lobpcg import lobpcg_gevp_adaptive

        return lobpcg_gevp_adaptive(A, C, params, prec_inv=prec_inv)
    raise ValueError(f"Unknown eigensolver type '{params.type}'")
