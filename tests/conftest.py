"""Test configuration.

Everything runs on a virtual 8-device CPU mesh, so the sharding paths
are exercised on XLA's host-platform devices and x64 jnp semantics hold.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which decides at run time whether a card is
present and skips with a reason when it is not. The card-side checks of
the main path live in ``chip_smoke.py`` at the repository root. On a
machine with a card:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
    python chip_smoke.py
"""

import os

import pytest

# the CPU unless the caller names platforms, e.g. JAX_PLATFORMS=cuda,cpu
# to run the ``gpu`` tests on a card
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skips (via the gpu_device fixture) "
        "where JAX finds none",
    )


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU; JAX found none")
    return devs[0]
