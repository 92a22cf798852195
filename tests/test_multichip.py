"""Multi-device SPMD tests on the virtual 8-device CPU mesh.

The analogue of the reference's oversubscribed-MPI distributed tests
(reference: tests/CMakeLists.txt:1-3, MPI_RANKS 1 4 16 32): the sharded
execution path — GSPMD-sharded SETUP in api.build_preconditioner(mesh=...)
(core/mesh.py setup_sharding) plus the shard_map SOLVE (psum halo reductions
in precond/schwarz.py, all_gather + replicated coarse solve in
precond/galerkin.py) — must produce the SAME iterates, and therefore
iteration counts, as the single-device batched path, for every coarse-space
and solver config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ddm_jax.api import default_ptree, setup_problem, solve, build_preconditioner
from ddm_jax.core.mesh import subdomain_mesh


def _problem(coarse="none", parts=(4, 2), gridsize=24, nev=4):
    pt = default_ptree()
    pt["gridsize"] = gridsize
    pt["solver.type"] = "cgsolver"
    pt["solver.reduction"] = 1e-8
    pt["solver.maxit"] = 200
    # standard AS keeps the preconditioner symmetric for CG
    pt["schwarz.type"] = "standard"
    pt["schwarz.subdomain_solver.type"] = "cholesky"
    if coarse != "none":
        pt["coarsespace.type"] = coarse
        pt[f"{coarse}.eigensolver.nev"] = nev
        pt[f"{coarse}.eigensolver.threshold"] = -1.0
    return setup_problem(pt, parts=parts)


@pytest.fixture(scope="module")
def mesh8():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return subdomain_mesh(8)


def test_one_level_sharded_matches_single_device(mesh8):
    p = _problem("none")
    res_ref = solve(p)
    res_sh = solve(p, mesh=mesh8)
    assert int(res_sh.iterations) == int(res_ref.iterations)
    assert bool(res_sh.converged)
    np.testing.assert_allclose(
        np.asarray(res_sh.x), np.asarray(res_ref.x), rtol=1e-12, atol=1e-12
    )


def test_two_level_geneo_sharded_matches_single_device(mesh8):
    p = _problem("geneo")
    res_ref = solve(p)
    res_sh = solve(p, mesh=mesh8)
    assert bool(res_sh.converged)
    assert int(res_sh.iterations) == int(res_ref.iterations)
    np.testing.assert_allclose(
        np.asarray(res_sh.x), np.asarray(res_ref.x), rtol=1e-10, atol=1e-12
    )


def test_sharded_prec_state_is_distributed(mesh8):
    """The subdomain-batched preconditioner state must actually be sharded
    over the mesh, not replicated."""
    p = _problem("none")
    prec = build_preconditioner(p, mesh=mesh8)
    shardings = {
        str(leaf.sharding.spec)
        for leaf in jax.tree.leaves(prec)
        if hasattr(leaf, "sharding") and leaf.ndim >= 1
        and leaf.shape[0] == p.topo.n_sub
    }
    assert shardings == {"PartitionSpec('sub',)"}


def test_setup_is_sharded_during_build(mesh8):
    """The EXPENSIVE setup state (subdomain inverses, coarse basis) must be
    computed sharded — committed to P('sub') as produced, not re-sharded
    after a single-device build."""
    from ddm_jax.core.mesh import setup_sharding
    from ddm_jax.precond.schwarz import build_schwarz

    p = _problem("none")
    with setup_sharding(mesh8, p.topo.n_sub):
        fine = build_schwarz(p.A, p.topo, p.pou, p.ptree)
    # the factor batch came OUT of the build already sharded
    fac = getattr(fine.factors, "inv", None)
    if fac is None:
        fac = fine.factors.chol
    assert str(fac.sharding.spec) == "PartitionSpec('sub',)"


def _sharded_parity(pt_mutator, mesh, parts=(4, 2), gridsize=24,
                    problem_name=None, exact=True):
    """Full config-driven pipeline, sharded vs single-device."""
    from ddm_jax.fem import problems as problems_mod

    pt = default_ptree()
    pt["gridsize"] = gridsize
    pt["solver.type"] = "restartedgmressolver"
    pt["solver.reduction"] = 1e-8
    pt["solver.maxit"] = 300
    pt["schwarz.subdomain_solver.type"] = "cholesky"
    pt_mutator(pt)
    problem = problems_mod.PROBLEMS[problem_name]() if problem_name else None
    p = setup_problem(pt, problem=problem, parts=parts)
    res_ref = solve(p)
    res_sh = solve(p, mesh=mesh)
    assert bool(res_sh.converged)
    if exact:
        assert int(res_sh.iterations) == int(res_ref.iterations)
    else:
        # iterative eigensolvers are tolerance-converged, so the coarse
        # bases of the two runs may differ at the tolerance level
        assert abs(int(res_sh.iterations) - int(res_ref.iterations)) <= 2
    return res_ref, res_sh


def test_sharded_setup_restricted_geneo(mesh8):
    """Restricted Schwarz + GenEO through the public API: the full setup
    (extract -> factor -> GEVP -> coarse) runs sharded."""

    def mut(pt):
        pt["coarsespace.type"] = "geneo"
        pt["geneo.eigensolver.nev"] = 3
        pt["geneo.eigensolver.threshold"] = -1.0

    _sharded_parity(mut, mesh8)


def test_sharded_setup_geneo_ring(mesh8):
    def mut(pt):
        pt["coarsespace.type"] = "geneo_ring"
        pt["geneo_ring.eigensolver.nev"] = 3
        pt["geneo_ring.eigensolver.threshold"] = -1.0

    _sharded_parity(mut, mesh8)


def test_sharded_setup_msgfem(mesh8):
    def mut(pt):
        pt["coarsespace.type"] = "msgfem"
        pt["msgfem.eigensolver.nev"] = 3
        pt["msgfem.eigensolver.threshold"] = -1.0

    _sharded_parity(mut, mesh8)


def test_sharded_setup_lobpcg(mesh8):
    """Config-dispatched iterative eigensolver under sharded setup."""

    def mut(pt):
        pt["coarsespace.type"] = "geneo"
        pt["geneo.eigensolver.type"] = "lobpcg"
        pt["geneo.eigensolver.nev"] = 3
        pt["geneo.eigensolver.threshold"] = -1.0
        pt["geneo.eigensolver.maxit"] = 60

    _sharded_parity(mut, mesh8, exact=False)


def test_gmres_sharded_two_level(mesh8):
    """Two-level GenEO-RAS under GMRES, sharded vs single-device parity on
    a heterogeneous (islands) problem — the headline configuration."""
    from ddm_jax.fem import problems as problems_mod

    pt = default_ptree()
    pt["gridsize"] = 32
    pt["solver.type"] = "restartedgmressolver"
    pt["solver.reduction"] = 1e-8
    pt["solver.maxit"] = 200
    pt["schwarz.subdomain_solver.type"] = "cholesky"
    pt["coarsespace.type"] = "geneo"
    pt["geneo.eigensolver.nev"] = 4
    pt["geneo.eigensolver.threshold"] = -1.0
    problem = problems_mod.PROBLEMS["islands"]()
    p = setup_problem(pt, problem=problem, parts=(4, 2))
    res_ref = solve(p)
    res_sh = solve(p, mesh=mesh8)
    assert bool(res_sh.converged)
    assert int(res_sh.iterations) == int(res_ref.iterations)


def test_sharded_setup_newton_construction(mesh8):
    """The f32-seed + f64 Newton factorise (accelerator default construction,
    solvers/direct.py:newton_inverse_batched) under the sharded setup: the
    per-chunk residual-controlled host loop must work with GSPMD-sharded
    chunks and produce the same iterates as the single-device build."""

    def mut(pt):
        pt["coarsespace.type"] = "geneo"
        pt["geneo.eigensolver.nev"] = 3
        pt["geneo.eigensolver.threshold"] = -1.0
        # force the accelerator-default construction on CPU; dd precision
        # forces the explicit-inverse mode that makes it live
        pt["schwarz.subdomain_solver.construction"] = "newton"
        pt["schwarz.subdomain_solver.precision"] = "dd"
        pt["solver.reduction"] = 1e-6

    _sharded_parity(mut, mesh8)


def test_sharded_chunk_boundary(mesh8, monkeypatch):
    """chunked_batch must split and re-commit chunks under an active
    setup_sharding (solvers/direct.py chunk re-commit path): force
    DDM_BATCH_CHUNK=1 so the per-device budget (1 * 8 devices = 8) is
    below n_sub = 16 and the factorization runs in two sharded chunks.
    """
    monkeypatch.setenv("DDM_BATCH_CHUNK", "1")

    import ddm_jax.solvers.direct as direct

    calls = {"n": 0}
    orig = direct.chunked_batch

    def spy(fn, *arrays, chunk=None):
        # count chunk pieces via the first array's split
        n = arrays[0].shape[0]
        calls["n"] = max(calls["n"], n)
        return orig(fn, *arrays, chunk=chunk)

    monkeypatch.setattr(direct, "chunked_batch", spy)
    import ddm_jax.precond.schwarz as schwarz_mod

    monkeypatch.setattr(schwarz_mod, "chunked_batch", spy)

    def mut(pt):
        pt["schwarz.type"] = "restricted"
        # direct construction exercises chunked_batch (the CPU default)

    res_ref, res_sh = _sharded_parity(mut, mesh8, parts=(4, 4), gridsize=24)
    assert calls["n"] == 16  # chunked_batch really saw the 16-subdomain batch
    np.testing.assert_allclose(
        np.asarray(res_sh.x), np.asarray(res_ref.x), rtol=0, atol=1e-9
    )
