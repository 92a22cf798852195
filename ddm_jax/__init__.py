"""ddm_jax — a batched domain-decomposition framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the DUNE module
``dune-ddm`` (overlapping Schwarz preconditioners with spectral coarse spaces
for FEM discretizations).  See SURVEY.md at the repository root for the layer
map of the reference and the architecture of this rebuild.

Design (batched on one accelerator, not a port):

* One *subdomain per MPI rank* in the reference becomes a **batch dimension
  over subdomains**, sharded over a ``jax.sharding.Mesh`` axis.  All
  per-subdomain work (Schwarz solves, eigenproblems, extensions) runs as one
  batched device op instead of per-rank sequential code.
* DUNE's parallel index sets / overlap-extension MPI rounds
  (reference: dune/ddm/overlap_extension.hh, datahandles.hh) become
  **host-precomputed static int32 index maps** (core/indexmaps.py).
* Sparse direct subdomain solvers (UMFPACK/CHOLMOD) become **batched dense
  factorizations** of padded subdomain matrices (solvers/direct.py).
* Spectra's shift-invert Lanczos GEVP (dune/ddm/eigensolvers/spectra.hh)
  becomes a **batched dense/LOBPCG generalized eigensolver** (eigen/).
* MPI halo exchange and rank-0 coarse solves become gathers/scatter-adds and
  replicated dense coarse solves expressed inside one ``jit``.

Float64 is enabled by default (required for iteration-count parity with the
ISTL solvers at reductions of 1e-8..1e-10).  Set the environment variable
``DDM_X64=0`` before import to opt out.
"""

import os as _os

import jax as _jax

if _os.environ.get("DDM_X64", "1") != "0":
    _jax.config.update("jax_enable_x64", True)

# Persistent compilation cache.  JAX itself honours JAX_COMPILATION_CACHE_DIR;
# without it the cache goes to a fixed directory of the checkout, so every
# process of one checkout finds what an earlier one compiled.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"),
    )
# cache every program: a cold setup compiles hundreds of small eager ops,
# each below JAX's default one-second threshold
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

__version__ = "0.1.0"
