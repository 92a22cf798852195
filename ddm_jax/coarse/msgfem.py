"""MsGFEM coarse space (Multiscale GFEM with A-harmonicity constraint).

Rebuilds MsGFEMCoarseSpace (coarse_spaces.hh:663-831).  The reference builds
a saddle-point pencil of size 2*n_int + n_bnd with Lagrange-multiplier blocks
enforcing (A_dir u)_i = 0 in the subdomain interior, then shift-invert
Lanczos.  Mathematically the eigenproblem lives on the A-harmonic subspace,
so this build solves the *reduced* pencil directly:

    u = H w   (H = harmonic parameter basis, extension.py)
    Ahat = H^T A_nrg H,   Bhat = H^T P_int (D A_nrg D) P_int H
    Ahat w = lambda Bhat w,  smallest lambda kept

which is the same spectrum as the saddle formulation restricted to finite
eigenvalues, computed as batched dense ops.

Variants (wired as in examples/pdelab_schwarz.hh:102-135):
* msgfem:            A_nrg = subdomain Neumann matrix, A_con = A_dir
* msgfem_euclid:     A_nrg = I (Euclidean energy), A_con = A_dir
* algebraic_msgfem:  A_nrg = algebraic Neumann (Al Daas et al.), A_con = A_dir
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.mesh import batched
import numpy as np

from ..config import ParamTree
from ..eigen.dense_gevp import solve_gevp_dense_auto
from ..eigen.params import EigensolverParams
from .basis import finalize_basis
from .extension import harmonic_parameter_basis
from .geneo import algebraic_neumann, dirichlet_dense, neumann_matrices


def msgfem_coarse_space(p, ptree: ParamTree, variant: str = "msgfem"):
    topo = p.topo
    params = EigensolverParams.from_ptree(ptree.sub(f"{variant}.eigensolver"))
    pou = batched(p.pou)
    valid = topo.valid

    A_dir, dmask = dirichlet_dense(p)
    dmask_np = np.asarray(dmask)
    boundary = np.asarray(topo.boundary)
    int_mask = valid & ~boundary & ~dmask_np
    par_mask = valid & boundary & ~dmask_np

    if variant == "msgfem":
        A_nrg, _ = neumann_matrices(p, region_b="all")
    elif variant == "msgfem_euclid":
        A_nrg = jnp.broadcast_to(
            jnp.eye(topo.n_pad), (topo.n_sub, topo.n_pad, topo.n_pad)
        )
    elif variant == "algebraic_msgfem":
        A_nrg, _ = algebraic_neumann(p)
    else:
        raise ValueError(variant)

    nd = batched(valid & ~dmask_np)
    keep = nd[:, :, None] & nd[:, None, :]
    A_nrg = jnp.where(keep, A_nrg, 0.0)

    # rhs weight: POU-scaled A_nrg restricted to interior-interior pairs
    im = batched(int_mask)
    keep_int = im[:, :, None] & im[:, None, :]
    B = jnp.where(keep_int, A_nrg * pou[:, :, None] * pou[:, None, :], 0.0)

    H = harmonic_parameter_basis(A_dir, im, batched(par_mask))
    Ahat = jnp.einsum("spk,spq,sql->skl", H, A_nrg, H)
    Bhat = jnp.einsum("spk,spq,sql->skl", H, B, H)
    par = batched(par_mask)
    Ahat = Ahat + jnp.eye(topo.n_pad)[None] * (~par)[:, :, None]
    spd = variant != "algebraic_msgfem"
    lam, W, active = solve_gevp_dense_auto(Ahat, Bhat, params, spd=spd)
    V = jnp.einsum("spq,skq->skp", H, W)
    V = jnp.where(batched(valid)[:, None, :], V, 0.0)
    return finalize_basis(V, pou, batched(valid), active)
