"""Runtime-scripted PDE coefficients from a Python file.

The reference scripts coefficients through vendored LuaJIT
(examples/poisson_coefficient.lua etc., evaluated per quadrature point via
LuaProblem, examples/poisson_problems.hh).  The analogue here loads a Python
file defining vectorized jnp callables — same workflow (edit a script, rerun
the driver with ``-coefficient_file``), but the functions trace into the
XLA assembly kernels instead of being interpreted per point.

The scripted file may define any of: ``alpha(x)``, ``b(x)``, ``c(x)``,
``f(x)``, ``g(x)``, ``is_dirichlet(x)`` (vectorized over (..., d) coords),
or scalar-signature ``alpha(x, y[, z])`` variants which are adapted
automatically.
"""

from __future__ import annotations

import inspect
import runpy

import jax.numpy as jnp

from .problems import Problem


def _adapt(fn, vector_valued=False):
    """Accept either vectorized f(coords) or per-point f(x, y[, z])."""
    n_args = len(inspect.signature(fn).parameters)
    if n_args == 1:
        return fn

    def wrapped(xq):
        comps = [xq[..., i] for i in range(n_args)]
        out = fn(*comps)
        if vector_valued and isinstance(out, (tuple, list)):
            return jnp.stack([jnp.broadcast_to(o, xq.shape[:-1]) for o in out],
                             axis=-1)
        return out

    return wrapped


def load_problem(path: str, name: str | None = None) -> Problem:
    ns = runpy.run_path(path)
    kwargs = {"name": name or path}
    if "alpha" in ns:
        kwargs["alpha"] = _adapt(ns["alpha"])
    if "f" in ns:
        kwargs["f"] = _adapt(ns["f"])
    if "g" in ns:
        kwargs["g"] = _adapt(ns["g"])
    if "c" in ns:
        kwargs["c"] = _adapt(ns["c"])
    if "is_dirichlet" in ns:
        kwargs["is_dirichlet"] = _adapt(ns["is_dirichlet"])
    if "b" in ns:
        kwargs["b"] = _adapt(ns["b"], vector_valued=True)
        kwargs["symmetric"] = False
    elif "b1" in ns and "b2" in ns:
        b1, b2 = _adapt(ns["b1"]), _adapt(ns["b2"])

        def b(xq):
            return jnp.stack(
                [jnp.broadcast_to(b1(xq), xq.shape[:-1]),
                 jnp.broadcast_to(b2(xq), xq.shape[:-1])], axis=-1)

        kwargs["b"] = b
        kwargs["symmetric"] = False
    return Problem(**kwargs)


def load_elasticity_problem(path: str, name: str | None = None):
    """Elasticity coefficients from a Python script (the analogue of the
    reference's coefficient.lua + LuaProblem for linearelasticity.cc).

    The script defines either ``lam``/``mu`` directly or
    ``youngs_modulus``/``poisson_ratio`` (per-point (x, y, z) or vectorized
    signatures), plus optional ``f``/``g``/``is_dirichlet``.  Lame
    parameters derive from (E, nu) exactly as coefficient.lua:62-72 does.
    """
    import jax.numpy as jnp

    from .problems import ElasticityProblem, steel_rubber_bar

    ns = runpy.run_path(path)
    default = steel_rubber_bar()
    if "lam" in ns and "mu" in ns:
        lam, mu = _adapt(ns["lam"]), _adapt(ns["mu"])
    elif "youngs_modulus" in ns and "poisson_ratio" in ns:
        E_fn = _adapt(ns["youngs_modulus"])
        nu_fn = _adapt(ns["poisson_ratio"])

        def lam(xq):
            E, nu = E_fn(xq), nu_fn(xq)
            return E * nu / (1.0 + nu) / (1.0 - 2.0 * nu)

        def mu(xq):
            E, nu = E_fn(xq), nu_fn(xq)
            return E / 2.0 / (1.0 + nu)
    else:
        raise KeyError(
            f"{path}: elasticity coefficient file must define lam/mu or "
            "youngs_modulus/poisson_ratio"
        )
    return ElasticityProblem(
        lam=lam,
        mu=mu,
        f=_adapt(ns["f"], vector_valued=True) if "f" in ns else default.f,
        g=_adapt(ns["g"], vector_valued=True) if "g" in ns else default.g,
        is_dirichlet=(_adapt(ns["is_dirichlet"]) if "is_dirichlet" in ns
                      else default.is_dirichlet),
        name=name or path,
    )
