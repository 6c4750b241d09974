import os
import pathlib

import pytest

# The suite runs on the host CPU backend with a virtual 8-device mesh, so
# sharding tests exercise real multi-device code paths. jax.config still
# wins over an earlier jax import as long as no backend is initialized yet.
# NIQKI_TPU_TEST_GPU=1 (set by chip_smoke.py, which runs the tests marked
# ``gpu`` in its own process on the card) leaves the platform alone.
GPU_RUN = bool(os.environ.get("NIQKI_TPU_TEST_GPU"))
if not GPU_RUN:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not GPU_RUN:
    jax.config.update("jax_platforms", "cpu")

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
REFERENCE_RESOURCES = pathlib.Path("/root/reference/resources")


def pytest_configure(config):
    if GPU_RUN:
        return
    assert jax.devices()[0].platform == "cpu", (
        "tests must run on the host CPU backend, got "
        f"{jax.devices()}")


@pytest.fixture(scope="session")
def fixtures():
    return FIXTURES


@pytest.fixture(scope="session")
def ecoli_dir():
    if not REFERENCE_RESOURCES.exists():
        pytest.skip("reference resources not available")
    return REFERENCE_RESOURCES
