"""Test configuration: the CPU with a virtual 8-device mesh by default.

JAX_PLATFORMS, when given, picks the platform instead: the chip-marked
tests run on a GPU with `JAX_PLATFORMS=cuda python -m pytest -m chip
tests/`. Whether a GPU is present is decided in the `gpu` fixture, when
a test asks for it, never while modules are imported.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture(scope="session")
def gpu():
    """The first GPU device; skips the test where there is none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda python -m pytest "
                    "-m chip tests/)")
    return devices[0]
