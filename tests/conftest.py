"""Test configuration: run all tests on a virtual 8-device CPU mesh.

Mirrors the reference's test strategy of simulating multi-node runs with
oversubscribed local MPI ranks (reference: tests/CMakeLists.txt:1-3,
``MPI_RANKS 1 4 16 32 --oversubscribe``): distributed logic is exercised on
``xla_force_host_platform_device_count=8`` CPU devices so no accelerator is
needed (SURVEY.md §4).  Tests marked ``gpu`` check what only the card can
show; they skip here, and ``python chip_smoke.py`` runs their checks on the
card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # tests always run on the virtual CPU mesh
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs this check on the card")
    return jax.devices()[0]


def reference_mesh(name: str) -> str:
    """Path of a shipped reference mesh; skip the calling test when the
    read-only reference checkout is not present on this machine."""
    path = f"/root/reference/data/{name}"
    if not os.path.exists(path):
        pytest.skip(f"reference mesh {name} not available")
    return path
