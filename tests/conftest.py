"""Test configuration.

Puts JAX on the CPU backend with 8 virtual devices (unless
``JAX_PLATFORMS`` says otherwise) so the multi-device sharding paths (mesh +
halo exchange) are exercised without accelerator hardware — the device
analog of the reference's threads × block-size partitioning-invariance
sweep (``tests/test_search_engine.cpp:62-69``).

Tests marked ``gpu`` need an NVIDIA card; the ``gpu_device`` fixture skips
them elsewhere.  On a machine with a card run them with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os

# Must run before jax is imported anywhere.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX runs on no GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX backend: "
                    f"{jax.default_backend()})")
    return jax.devices()[0]
