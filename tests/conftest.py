"""Test environment: the CPU with 8 virtual devices, set BEFORE jax is
imported, so sharding tests exercise a multi-device mesh without a GPU
(SURVEY.md §4 'distributed without a cluster'). Pallas kernels run in
interpret mode here. Tests that need the card are marked `gpu` and take the
`gpu` fixture; run them on the card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``."""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_threefry_partitionable", True)
jax.config.update("jax_default_matmul_precision", "highest")


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU — decided when
    the test runs, never at import or collection."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/")
