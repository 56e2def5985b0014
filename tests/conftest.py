"""Test configuration: the CPU backend with a virtual 8-device mesh.

The suite runs on the CPU (JAX_PLATFORMS defaults to cpu here); multi-card
sharding tests run on 8 virtual CPU devices.  Tests that need the GPU take
the `gpu` fixture, which skips them elsewhere; run them on the card with
`JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()


def pytest_configure(config):
    config.addinivalue_line("markers", "golden: golden-image comparison")
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU")


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")
    return jax.devices()[0]
