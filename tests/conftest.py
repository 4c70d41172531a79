"""Test environment: a virtual 8-device CPU mesh by default.

This is the JAX analog of the reference's compile-time backend substitution
(the `desktop_sph_fluid` target replacing OLED/MPU6050 hardware with SDL and
constant gravity, SURVEY.md §4) — tests need no accelerator, and
multi-device sharding tests get 8 virtual devices.

``JAX_PLATFORMS`` picks the platform (default ``cpu``).  Tests marked
``gpu`` need a GPU and skip elsewhere; on a machine with one, run them with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time, never
    at collection, so every worker collects the same tests)."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {platform}")


def pytest_report_header(config):
    return f"jax backend: {jax.default_backend()}, devices: {len(jax.devices())}"
