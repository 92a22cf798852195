"""One-level (restricted) additive Schwarz preconditioner, batched.

Rebuilds dune/ddm/schwarz.hh:35-220 as one batched device op.  The reference's
per-rank sequence

    copy defect -> halo copyOwnerToAll -> subdomain direct solve ->
    (restricted: multiply by POU) -> halo addOwnerCopyToOwnerCopy -> restrict

becomes

    gather (n_sub, n_pad) <- batched triangular solves <- POU scale <-
    scatter-add

with the subdomain factorizations held as a dense batch (solvers/direct.py).
Summing POU-weighted subdomain solutions over *all* subdomains at each global
dof reproduces exactly the reference's consistent result after
addOwnerCopyToOwnerCopy (schwarz.hh:138-143): every dof receives the sum of
contributions from every subdomain containing it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ParamTree
from ..core.indexmaps import DDMTopology, extraction_map
from ..core.sparse import SparseELL
from ..solvers.direct import chunked_batch, factor_batched_jit
from .extract import (
    extract_subdomain_dense,
    gather_subdomain,
    scatter_add_subdomain,
    scatter_add_subdomain_shard,
)


@jax.tree_util.register_dataclass
@dataclass
class SchwarzPreconditioner:
    sub2glob: jnp.ndarray  # (n_sub, n_pad) int32
    valid: jnp.ndarray  # (n_sub, n_pad) bool
    pou: jnp.ndarray  # (n_sub, n_pad) float; all-ones batch for standard AS
    factors: object  # BatchedLU | BatchedCholesky
    # when apply runs inside shard_map with the subdomain batch sharded over a
    # mesh axis, the scatter-add only sums the device-local subdomains; `axis`
    # names the mesh axis to psum over (the ICI halo reduction of SURVEY §5.8)
    axis: str | None = field(default=None, metadata=dict(static=True))
    # (K, n) gather-dual of the scatter (indexmaps.dual_scatter_map); its flat
    # indices address the FULL subdomain batch — the sharded apply embeds its
    # local slab into a zero full batch first (extract.py:
    # scatter_add_subdomain_shard)
    dualT: jnp.ndarray | None = None
    # structured-rect canvas layout (core/structured.py): bandwidth
    # gather/scatter; under shard_map the full-canvas transforms run
    # replicated (they are only ~n_sub*n_pad elements) and each device
    # slices/contributes its slab (structured.py:rect_*_shard)
    rect: object | None = field(default=None, metadata=dict(static=True))
    # full subdomain count (== sub2glob.shape[0] outside shard_map; inside,
    # the leaves are device-local slabs and this keeps the global batch size)
    n_sub_full: int = field(default=0, metadata=dict(static=True))

    def apply(self, d: jnp.ndarray) -> jnp.ndarray:
        from ..core.structured import (
            rect_gather,
            rect_gather_shard,
            rect_scatter_add,
            rect_scatter_add_shard,
        )

        n = d.shape[0]
        if self.rect is not None:
            if self.axis is None:
                d_sub = rect_gather(d, self.rect)
            else:
                d_sub = rect_gather_shard(
                    d, self.rect, self.axis, self.pou.shape[0]
                )
        else:
            d_sub = gather_subdomain(d, self.sub2glob)
        x_sub = self.factors.solve(d_sub)
        x_sub = jnp.where(self.valid, x_sub * self.pou, 0.0)
        if self.rect is not None:
            if self.axis is None:
                return rect_scatter_add(x_sub, self.rect)
            return rect_scatter_add_shard(x_sub, self.rect, self.axis)
        if self.axis is not None:
            if self.dualT is not None and self.n_sub_full:
                return scatter_add_subdomain_shard(
                    x_sub, self.dualT, self.axis, self.n_sub_full
                )
            return jax.lax.psum(
                scatter_add_subdomain(x_sub, self.sub2glob, n), self.axis
            )
        return scatter_add_subdomain(x_sub, self.sub2glob, n, dualT=self.dualT)


def build_schwarz(
    ell: SparseELL,
    topo: DDMTopology,
    pou: np.ndarray | None,
    ptree: ParamTree | None = None,
    subtree_name: str = "schwarz",
) -> SchwarzPreconditioner:
    """Set up the Schwarz preconditioner (reference ctor schwarz.hh:73-94).

    Config keys (subtree ``schwarz``): ``type`` = standard|restricted
    (default restricted); ``subdomain_solver.type`` = umfpack|cholmod|lu|
    cholesky (mandatory, mirroring the reference's explicit check
    schwarz.hh:89-91).
    """
    ptree = ptree or ParamTree({subtree_name: {"subdomain_solver": {"type": "lu"}}})
    sub = ptree.sub(subtree_name)
    type_string = sub.get("type", "restricted")
    if type_string not in ("standard", "restricted"):
        raise ValueError(f"Unknown Schwarz type '{type_string}'")
    solver_sub = sub.sub("subdomain_solver")
    if "type" not in solver_sub:
        raise KeyError(
            f"You must specify the solver in the subtree {subtree_name}."
            "subdomain_solver using the key 'type'"
        )
    solver_type = solver_sub.get("type")
    precision = solver_sub.get("precision", "f64")
    modify = ptree.get("modify_subdomain_matrix", False)

    from ..obs.logger import scoped

    from ..core.mesh import batched

    from .extract import rect_extract_ok

    rect = getattr(topo, "rect", None)
    # the extraction map (host build + 8 MB upload) is only read by the
    # general extraction path and the f32/dd sparse-refinement modes — skip
    # it when the scatter-free rect path serves an f64 build
    local_cols_j = None
    if precision in ("f32", "dd") or not rect_extract_ok(
        ell, rect, topo.n_pad
    ):
        local_cols_j = batched(extraction_map(topo, np.asarray(ell.colsT).T))
    sub2glob_j = batched(topo.sub2glob)
    valid_j = batched(topo.valid)
    with scoped("Schwarz", "extract"):
        A_sub = extract_subdomain_dense(
            ell, sub2glob_j, valid_j, local_cols_j, rect=rect,
        )
        if modify:
            # eliminate subdomain-boundary dofs before factorising
            # (reference option modify_subdomain_matrix,
            # pdelab_schwarz.hh:163-164)
            from ..fem.subassembly import eliminate_dirichlet_dense

            A_sub = eliminate_dirichlet_dense(
                A_sub, batched(topo.boundary) & valid_j
            )
        jax.block_until_ready(A_sub)
    with scoped("Schwarz", "factorise"):
        # reduced-precision applies need the explicit-inverse mode regardless
        # of backend (on CPU the default is triangular factors)
        mode = "inverse" if precision in ("f32", "dd") else "auto"
        sd = "dd" if precision == "dd" else None
        on_cpu = jax.default_backend() == "cpu"
        inverse_mode = mode == "inverse" or (mode == "auto" and not on_cpu)
        construction = solver_sub.get(
            "construction", "direct" if on_cpu else "newton"
        )
        from ..solvers.direct import newton_inverse_batched, resolve_solver_type

        if (construction == "newton" and inverse_mode
                and resolve_solver_type(solver_type) == "cholesky"):
            # f32 Cholesky seed + residual-controlled f64 Newton refinement
            # (matmul-only), with an automatic exact-f64 fallback per chunk
            # (solvers/direct.py:newton_inverse_batched).  newton_rtol
            # overrides the step-input stop threshold (default 1e-6 ->
            # exact-inverse grade ~1e-12 output residual); larger values
            # give a preconditioner-grade inverse in fewer f64 steps —
            # Newton error is MULTIPLICATIVE (X = A^{-1}(I+E)), so unlike
            # the failed additive f32 apply path it does not perturb the
            # small-eigenvalue structure.
            nrtol = solver_sub.get("newton_rtol", None)
            factors = newton_inverse_batched(
                A_sub, store_dtype=sd,
                rtol=float(nrtol) if nrtol is not None else None,
            )
        else:
            factors = chunked_batch(
                factor_batched_jit(solver_type, mode, store_dtype=sd), A_sub
            )
        jax.block_until_ready(factors)
    if precision in ("f32", "dd"):
        import dataclasses

        from ..solvers.direct import (
            BatchedInverse,
            BatchedInverseDD,
            SparseRefinedInverse,
        )

        rows = jnp.minimum(sub2glob_j, ell.n - 1)
        sub_vals, _ = ell.rows_dense_gather(rows)
        sub_vals = sub_vals * valid_j[:, :, None]
        sub_vals = jnp.where(local_cols_j >= topo.n_pad, 0.0, sub_vals)
        if precision == "dd":
            # double-single apply: exact f64-grade operator representation,
            # f32 arithmetic (solvers/direct.py:BatchedInverseDD) —
            # unlike the plain-f32 path, eps32*cond does NOT perturb the
            # operator (CLAUDE.md failed-f32 analysis), only incoherent
            # ~1e-6 accumulation noise remains per apply; an optional exact
            # sparse-f64 defect-correction step squashes even that.
            if not isinstance(factors, BatchedInverseDD):
                raise ValueError("precision=dd requires the inverse mode")
            factors = dataclasses.replace(
                factors, sub_vals=sub_vals, sub_cols=local_cols_j,
                # 2 exact-sparse defect-correction steps: reduces the
                # per-apply noise floor enough that verified-GMRES needs
                # notably fewer extra iterations (measured 42 -> 27 on
                # islands 64^2 at 1e-8)
                steps=int(solver_sub.get("refine_steps", 2)),
            )
        else:
            # f32 fast apply + exact-sparse f64 defect correction
            # (solvers/direct.py:SparseRefinedInverse)
            if not isinstance(factors, BatchedInverse):
                raise ValueError("precision=f32 requires the inverse mode")
            factors = SparseRefinedInverse(
                inv32=factors.inv.astype(jnp.float32),
                sub_vals=sub_vals,
                sub_cols=local_cols_j,
                steps=int(solver_sub.get("refine_steps", 2)),
            )

    if type_string == "restricted":
        if pou is None:
            raise ValueError("restricted Schwarz requires a partition of unity")
        pou_arr = batched(pou)
    else:
        pou_arr = batched(np.ones(topo.sub2glob.shape))

    from ..core.indexmaps import dual_scatter_map

    return SchwarzPreconditioner(
        sub2glob=sub2glob_j,
        valid=valid_j,
        pou=pou_arr,
        factors=factors,
        dualT=jnp.asarray(dual_scatter_map(topo)),
        rect=getattr(topo, "rect", None),
        n_sub_full=topo.n_sub,
    )
