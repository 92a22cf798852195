"""Subdomain-axis SPMD execution: the library's multi-chip path.

The reference distributes one subdomain per MPI rank and moves data with
DUNE parallel index sets (SURVEY.md §2.6, §5.8;
dune/ddm/overlap_extension.hh:53-285, galerkin_preconditioner.hh:151-194).
Here the subdomain batch axis is sharded over a ``jax.sharding.Mesh`` axis
and the three collective classes the algorithms need run as XLA
collectives between the devices:

* fine-level halo sum (addOwnerCopyToOwnerCopy) -> ``psum`` after the
  device-local scatter-add (precond/schwarz.py ``axis`` branch);
* coarse-defect collection (the reference's rank-0 Gatherv bottleneck) ->
  ``all_gather`` + replicated dense solve (precond/galerkin.py ``axis``
  branch);
* everything else (Krylov dots, SpMV) operates on vectors that are
  replicated across devices, so no collective is needed.

This module provides the glue: partition-spec inference for preconditioner
pytrees, axis-name injection, and a sharded Krylov driver used by
``api.solve(..., mesh=...)``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import AxisType, Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

DEFAULT_AXIS = "sub"


def subdomain_mesh(n_devices: int | None = None, axis: str = DEFAULT_AXIS) -> Mesh:
    """1-D device mesh over the subdomain axis.

    Auto axis type: the sharded SETUP path relies on GSPMD sharding
    propagation from committed inputs (gathers/scatters/cholesky/eigh all
    infer their output shardings under Auto; Explicit mode — jax.make_mesh's
    default — instead demands per-op out_sharding annotations and rejects
    mixed-sharding selects inside lax.linalg).  shard_map (the solve path)
    accepts Auto meshes unchanged."""
    n = n_devices if n_devices is not None else len(jax.devices())
    return jax.make_mesh((n,), (axis,), axis_types=(AxisType.Auto,))


def _auto_mesh(mesh: Mesh) -> Mesh:
    """Auto-axis-type view of ``mesh`` (see subdomain_mesh)."""
    if all(t == AxisType.Auto for t in mesh.axis_types):
        return mesh
    return Mesh(mesh.devices, mesh.axis_names,
                axis_types=(AxisType.Auto,) * len(mesh.axis_names))


# ---------------------------------------------------------------------------
# Sharded setup: the production build path (extract -> factorise -> GEVP ->
# coarse assembly) distributed over the subdomain mesh axis.
#
# The reference runs ALL of setup rank-parallel by construction (one
# subdomain per MPI rank: factorization schwarz.hh:85-92, eigensolves
# coarse_spaces.hh:319-331, coarse build galerkin_preconditioner.hh:219-349).
# Here the equivalent is GSPMD: while a setup_sharding context is active,
# every subdomain-batched array created through :func:`batched` is COMMITTED
# to NamedSharding(mesh, P(axis)), and XLA partitions every downstream
# batched op (dense extraction, Cholesky/LU, eigh, basis finalization, the
# pairwise coarse matrix) along the batch axis — computation follows data.
# This covers every coarse-space type and solver config without rewriting
# the builders as shard_map bodies; cross-subdomain steps (the pairs gather,
# the replicated coarse factor) get their collectives inserted by XLA.
# ---------------------------------------------------------------------------

_SETUP_SHARDING: list[tuple[Mesh, str, int]] = []


class setup_sharding:
    """Context manager activating sharded setup over ``mesh``'s ``axis``
    for arrays with leading (subdomain-batch) dimension ``n_sub``."""

    def __init__(self, mesh: Mesh, n_sub: int, axis: str = DEFAULT_AXIS):
        n_dev = mesh.shape[axis]
        if n_sub % n_dev:
            raise ValueError(
                f"subdomain count {n_sub} must divide evenly over the "
                f"{n_dev}-device mesh axis '{axis}'"
            )
        self.entry = (_auto_mesh(mesh), axis, n_sub)

    def __enter__(self):
        _SETUP_SHARDING.append(self.entry)
        return self

    def __exit__(self, *exc):
        _SETUP_SHARDING.pop()
        return False


def active_setup() -> tuple[Mesh, str, int] | None:
    """(mesh, axis, n_sub) of the innermost active setup_sharding, or None."""
    return _SETUP_SHARDING[-1] if _SETUP_SHARDING else None


def batched(x) -> jnp.ndarray:
    """``jnp.asarray`` that commits subdomain-batched arrays (leading dim ==
    the active context's n_sub) to the setup sharding.  Outside a
    setup_sharding context this is exactly ``jnp.asarray``.  Every builder
    on the setup path converts its batched inputs through here."""
    ctx = active_setup()
    if ctx is not None and not isinstance(x, jax.core.Tracer):
        # tracer guard: builders may also run under jit/shard_map (Newton
        # refresh, the shard_map solve body) where committing is the
        # transform's job, not ours
        mesh, axis, n_sub = ctx
        shape = getattr(x, "shape", None)
        if shape is not None and len(shape) >= 1 and shape[0] == n_sub:
            # direct device_put (host numpy lands pre-sliced per device; an
            # already-committed jnp array with the right sharding is a no-op)
            return jax.device_put(x, NamedSharding(mesh, P(axis)))
    return jnp.asarray(x)


def replicate(x) -> jnp.ndarray:
    """Commit ``x`` replicated over the active setup mesh (identity outside a
    context).  Used to pull small cross-subdomain quantities (the coarse
    matrix, activity masks) out of the sharded batch before replicated
    compute."""
    ctx = active_setup()
    if ctx is None or isinstance(x, jax.core.Tracer):
        return jnp.asarray(x)
    return jax.device_put(x, NamedSharding(ctx[0], P()))


def with_axis(prec, axis: str | None):
    """Copy of a preconditioner pytree with the mesh-axis name set on every
    component that reduces across subdomains (Schwarz scatter psum, Galerkin
    coarse all_gather).  Recurses through CombinedPreconditioner."""
    from ..precond.combined import CombinedPreconditioner

    if isinstance(prec, CombinedPreconditioner):
        return dataclasses.replace(
            prec, precs=tuple(with_axis(q, axis) for q in prec.precs)
        )
    if hasattr(prec, "axis"):
        return dataclasses.replace(prec, axis=axis)
    return prec


def batch_specs(tree, n_sub: int, axis: str):
    """PartitionSpec pytree for shard_map in_specs: leaves whose leading dim
    is the subdomain batch (== n_sub) shard over ``axis``; everything else
    (global vectors, the replicated coarse factor, scalars) replicates.

    Requires an unambiguous batch size: no non-batched leaf dimension may
    accidentally equal n_sub on axis 0 — true for every preconditioner here
    (global n >> n_sub, coarse factor carries a leading 1)."""

    def spec(leaf):
        if hasattr(leaf, "ndim") and leaf.ndim >= 1 and leaf.shape[0] == n_sub:
            return P(axis)
        return P()

    return jax.tree.map(spec, tree)


def replicated_specs(tree):
    return jax.tree.map(lambda _: P(), tree)


def shard_batched(tree, mesh: Mesh, n_sub: int, axis: str = DEFAULT_AXIS):
    """device_put the pytree with subdomain-batched leaves sharded over the
    mesh (so HBM for factors/bases is actually distributed) and the rest
    replicated."""

    def put(leaf, spec):
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree.map(put, tree, batch_specs(tree, n_sub, axis))


def solve_sharded(
    ell,
    prec,
    b: jnp.ndarray,
    x0: jnp.ndarray,
    ptree,
    mesh: Mesh,
    n_sub: int,
    axis: str = DEFAULT_AXIS,
    subtree_name: str = "solver",
):
    """Krylov solve under shard_map over the subdomain axis.

    The operator and the solution/defect vectors are replicated; only the
    preconditioner's subdomain-batched state is sharded.  Produces the same
    iterates (and therefore iteration counts) as the unsharded solve: the
    per-device scatter-add + psum sums exactly the same per-subdomain
    contributions as the single-device scatter-add.
    """
    from ..solvers.krylov import operator_of, prec_of, solve_from_config

    n_dev = mesh.shape[axis]
    if n_sub % n_dev:
        raise ValueError(
            f"subdomain count {n_sub} must divide evenly over the "
            f"{n_dev}-device mesh axis '{axis}'"
        )
    prec_l = with_axis(prec, axis)
    in_specs = (
        replicated_specs(ell),
        batch_specs(prec_l, n_sub, axis),
        P(),
        P(),
    )

    def body(ell_, prec_, b_, x0_):
        return solve_from_config(
            operator_of(ell_), prec_of(prec_), b_, x0_, ptree, subtree_name
        )

    fn = jax.jit(
        jax.shard_map(
            body, mesh=mesh, in_specs=in_specs, out_specs=P(), check_vma=True
        )
    )
    return fn(ell, prec_l, b, x0)
