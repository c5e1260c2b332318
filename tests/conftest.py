"""Test configuration.

The tests run on the CPU with 8 virtual devices unless JAX_PLATFORMS says
otherwise; multi-device sharding is validated on the virtual CPU mesh.
Tests marked `gpu` need an NVIDIA GPU: they take the `gpu` fixture, which
skips them elsewhere. On a machine with a card, run them with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is an NVIDIA GPU. Decided when the
    test runs, never while modules are imported or collected."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda, -m gpu)")
