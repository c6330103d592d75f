"""Test env: force the CPU backend with an 8-device virtual mesh.

Must run before the jax BACKEND initializes (the standard JAX fake-backend
trick for testing sharding code without a multi-card host). jax may already
be in sys.modules when this conftest runs; that is fine as long as no
backend has been created yet, so we redirect via jax.config and then assert
the invariant that actually matters: CPU platform, 8 virtual devices.

Tests that need the card carry the `gpu` marker and take the `gpu_device`
fixture, which skips them here; they run on the card through
`python -m pytest tests/ -m gpu` with JAX's default platform.
"""
import os
import sys

import pytest

_ON_CARD = os.environ.get("PT_TESTS_ON_GPU") == "1"
if not _ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not _ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu", (
        "tests must run on the CPU backend, got %s"
        % jax.devices()[0].platform)
    assert len(jax.devices()) == 8, (
        "tests need the 8-device virtual CPU mesh, got %d"
        % len(jax.devices()))

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where there is none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return jax.devices()[0]
