"""Test configuration: an 8-device virtual CPU platform by default.

Tests run on the CPU unless ``JAX_PLATFORMS`` names another platform, on a
virtual 8-device mesh (``--xla_force_host_platform_device_count=8``) so the
sharding logic is testable without several cards; the compositing kernels
run through the Pallas interpreter.  Tests marked ``gpu`` compile the
kernels for a real card and skip without one:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu():
    """Skip the test unless JAX's first device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/")
    return jax.devices()[0]
