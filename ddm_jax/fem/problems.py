"""Model problems: PDE coefficients as JAX callables.

Replaces the reference's coefficient layer — both the hard-coded PDELab model
problems (examples/poisson.hh: PoissonModelProblem "beams",
IslandsModelProblem) and the LuaJIT-scripted coefficients
(examples/poisson_coefficient.lua, convection_diffusion_coefficient.lua,
coefficient.lua).  Here, runtime Lua scripting is replaced by Python/jnp
callables evaluated at quadrature points at trace time, which XLA constant-
folds or fuses into the assembly kernels.

All callables are vectorized: coordinates arrive as (..., d) arrays and return
(...) scalars (or (..., d) for vector fields).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import jax.numpy as jnp


@dataclass
class Problem:
    """Scalar convection-diffusion problem description.

    a(u,v) = ∫ alpha ∇u·∇v + (b·∇u) v + c u v,  rhs ∫ f v, u = g on the
    Dirichlet part of the boundary selected by ``is_dirichlet``.
    """

    alpha: Callable = lambda x: jnp.ones(x.shape[:-1])
    b: Callable | None = None  # convection field (..., d) or None
    c: Callable | None = None  # reaction
    f: Callable = lambda x: jnp.zeros(x.shape[:-1])
    g: Callable = lambda x: jnp.zeros(x.shape[:-1])
    is_dirichlet: Callable = lambda x: jnp.ones(x.shape[:-1], bool)
    name: str = "custom"
    symmetric: bool = True

    def symmetrized(self) -> "Problem":
        """Elliptic part only (convection dropped) — the reference's
        ``make_elliptic`` flag used for eigenproblem operators
        (convection_diffusion_problems.hh:54-66)."""
        return Problem(
            alpha=self.alpha,
            b=None,
            c=self.c,
            f=self.f,
            g=self.g,
            is_dirichlet=self.is_dirichlet,
            name=self.name + "_elliptic",
            symmetric=True,
        )


def simple() -> Problem:
    """α=1, f=1, g=0, Dirichlet everywhere (reference: PoissonModelProblem;
    its A() returns the identity tensor — the beams coefficient computed there
    is dead code, see poisson.hh:96-99)."""
    return Problem(
        f=lambda x: jnp.ones(x.shape[:-1]),
        name="simple",
    )


def beams() -> Problem:
    """The *intended* beams coefficient of PoissonModelProblem
    (poisson.hh:69-93): 8 vertical high-coefficient beams of width 0.02 with
    small hooks near y=0.95, contrast 1e6."""
    width = 0.02
    small, large = 1.0, 1e6
    nb, space = 8, 0.1

    def alpha(xq):
        x, y = xq[..., 0], xq[..., 1]
        coeff = jnp.full(x.shape, small)
        hit = jnp.zeros(x.shape, bool)
        for i in range(1, nb + 1):
            in_beam = (x >= i * space) & (x <= i * space + width)
            in_hook1 = (y >= 0.95 - width) & (x >= i * space) & (x <= i * space + 3 * width)
            in_hook2 = (
                (y >= 0.95 - 2 * width)
                & (x >= i * space + 2 * width)
                & (x <= i * space + 3 * width)
            )
            hit = hit | in_beam | in_hook1 | in_hook2
        return jnp.where((y <= 0.95) & hit, large, coeff)

    return Problem(alpha=alpha, f=lambda x: jnp.ones(x.shape[:-1]), name="beams")


def islands() -> Problem:
    """IslandsModelProblem (poisson.hh:143-166) == poisson_coefficient.lua:
    diagonal bands, triangle region and a checkerboard of high-contrast
    islands; Dirichlet at x=0 and x=1 with g = 1-x, f = 0."""

    def alpha(xq):
        x, y = xq[..., 0], xq[..., 1]
        kappa = jnp.ones(x.shape)
        kappa = jnp.where(
            (x > 0.3) & (x < 0.9) & (y > 0.6 - (x - 0.3) / 6) & (y < 0.8 - (x - 0.3) / 6),
            1e5 * (x + y) * 10.0,
            kappa,
        )
        kappa = jnp.where(
            (x > 0.1) & (x < 0.5) & (y > 0.1 + x) & (y < 0.25 + x),
            1e5 * (1.0 + 7.0 * y),
            kappa,
        )
        kappa = jnp.where(
            (x > 0.5)
            & (x < 0.9)
            & (y > 0.15 - (x - 0.5) * 0.25)
            & (y < 0.35 - (x - 0.5) * 0.25),
            1e5 * 2.5,
            kappa,
        )
        ix = jnp.floor(15.0 * x).astype(jnp.int32)
        iy = jnp.floor(15.0 * y).astype(jnp.int32)
        kappa = jnp.where(
            (ix % 2 == 0) & (iy % 2 == 0), 1e5 * (1.0 + ix + iy), kappa
        )
        return kappa

    return Problem(
        alpha=alpha,
        g=lambda x: 1.0 - x[..., 0],
        is_dirichlet=lambda x: (x[..., 0] < 1e-6) | (x[..., 0] > 1.0 - 1e-6),
        name="islands",
    )


def checkerboard_convection_diffusion(nx: int = 8, ny: int = 8) -> Problem:
    """convection_diffusion_coefficient.lua: 8x8 checkerboard alpha in
    {1e-6, 1}, convection b = (1/3, 1), Dirichlet at x=0 (g=1) and y=0 (g=0).
    Nonsymmetric — exercised by the DG/GMRES config."""

    def alpha(xq):
        ix = jnp.floor(xq[..., 0] * nx).astype(jnp.int32)
        iy = jnp.floor(xq[..., 1] * ny).astype(jnp.int32)
        return jnp.where(ix % 2 == iy % 2, 1.0, 1e-6)

    def b(xq):
        shape = xq.shape[:-1]
        return jnp.stack(
            [jnp.full(shape, 1.0 / 3.0), jnp.ones(shape)], axis=-1
        )

    return Problem(
        alpha=alpha,
        b=b,
        g=lambda x: jnp.where(x[..., 0] < 1e-6, 1.0, 0.0),
        is_dirichlet=lambda x: (x[..., 0] < 1e-6) | (x[..., 1] < 1e-6),
        name="checkerboard_cd",
        symmetric=False,
    )


def dg_heterogeneous() -> Problem:
    """The reference's DG test problem (examples/convectiondiffusiondg.hh):
    alpha = 0.01 with a 1e5 block in [0.3,0.4]^2, convection b = (1,1),
    Gaussian source at (0.2, 0.2), Dirichlet g=0 everywhere except outflow at
    x > 1-1e-6 or y > 1-1e-6."""

    def alpha(xq):
        x, y = xq[..., 0], xq[..., 1]
        return jnp.where(
            (x > 0.3) & (x < 0.4) & (y > 0.3) & (y < 0.4), 1e5, 0.01
        )

    def b(xq):
        shape = xq.shape[:-1]
        return jnp.stack([jnp.ones(shape), jnp.ones(shape)], axis=-1)

    def f(xq):
        r2 = (xq[..., 0] - 0.2) ** 2 + (xq[..., 1] - 0.2) ** 2
        return 100.0 * jnp.exp(-r2 / 0.05**2)

    return Problem(
        alpha=alpha,
        b=b,
        f=f,
        is_dirichlet=lambda x: (x[..., 0] <= 1.0 - 1e-6) & (x[..., 1] <= 1.0 - 1e-6),
        name="dg_heterogeneous",
        symmetric=False,
    )


@dataclass
class ElasticityProblem:
    """Linear elasticity coefficients (reference: coefficient.lua +
    examples/linearelasticity.{cc,hh}: a steel-reinforced rubber bar)."""

    lam: Callable
    mu: Callable
    f: Callable
    g: Callable
    is_dirichlet: Callable
    name: str = "elasticity"


def steel_rubber_bar() -> ElasticityProblem:
    """coefficient.lua: 2x4 steel bars (E=2e11, nu=0.3) in rubber
    (E=2e7, nu=0.45), bars along x in [0,3], clamped at x=0, gravity load."""
    bar_r = 0.04
    bars_y = jnp.array([0.25, 0.75])
    bars_z = jnp.array([0.3, 0.6, 0.9, 1.2])

    def in_bar(xq):
        x, y, z = xq[..., 0], xq[..., 1], xq[..., 2]
        d2 = (y[..., None, None] - bars_y[:, None]) ** 2 + (
            z[..., None, None] - bars_z[None, :]
        ) ** 2
        inside_r = (d2 <= bar_r**2).any(axis=(-2, -1))
        return inside_r & (x >= 0.0) & (x <= 3.0)

    def young_nu(xq):
        steel = in_bar(xq)
        E = jnp.where(steel, 2e11, 2e7)
        nu = jnp.where(steel, 0.3, 0.45)
        return E, nu

    def lam(xq):
        E, nu = young_nu(xq)
        return E * nu / (1.0 + nu) / (1.0 - 2.0 * nu)

    def mu(xq):
        E, nu = young_nu(xq)
        return E / 2.0 / (1.0 + nu)

    def f(xq):
        shape = xq.shape[:-1]
        return jnp.stack(
            [jnp.zeros(shape), jnp.zeros(shape), jnp.full(shape, -9.81 * 1e4)],
            axis=-1,
        )

    return ElasticityProblem(
        lam=lam,
        mu=mu,
        f=f,
        g=lambda x: jnp.zeros(x.shape[:-1] + (3,)),
        is_dirichlet=lambda x: x[..., 0] < 1e-9,
        name="steel_rubber_bar",
    )


def steel_rubber_2d() -> ElasticityProblem:
    """2-D cross-section analogue of :func:`steel_rubber_bar` (reference:
    examples/coefficient.lua bars, reduced by one dimension): steel strips
    (E=2e11, nu=0.3) at y = 0.25 / 0.75 in rubber (E=2e7, nu=0.45) on
    [0,3]x[0,1], clamped at x=0, gravity load.  Same 1e4 stiffness contrast
    as the 3-D bar — used by the elasticity bench config at >=100k dofs."""
    bar_r = 0.04
    bars_y = jnp.array([0.25, 0.75])

    def in_bar(xq):
        x, y = xq[..., 0], xq[..., 1]
        near = (jnp.abs(y[..., None] - bars_y) <= bar_r).any(axis=-1)
        return near & (x >= 0.0) & (x <= 3.0)

    def young_nu(xq):
        steel = in_bar(xq)
        E = jnp.where(steel, 2e11, 2e7)
        nu = jnp.where(steel, 0.3, 0.45)
        return E, nu

    def lam(xq):
        E, nu = young_nu(xq)
        return E * nu / (1.0 + nu) / (1.0 - 2.0 * nu)

    def mu(xq):
        E, nu = young_nu(xq)
        return E / 2.0 / (1.0 + nu)

    def f(xq):
        shape = xq.shape[:-1]
        return jnp.stack(
            [jnp.zeros(shape), jnp.full(shape, -9.81 * 1e4)], axis=-1
        )

    return ElasticityProblem(
        lam=lam,
        mu=mu,
        f=f,
        g=lambda x: jnp.zeros(x.shape[:-1] + (2,)),
        is_dirichlet=lambda x: x[..., 0] < 1e-9,
        name="steel_rubber_2d",
    )


PROBLEMS = {
    "simple": simple,
    "beams": beams,
    "islands": islands,
    "checkerboard_cd": checkerboard_convection_diffusion,
}
