"""Test configuration: the CPU with an 8-device virtual mesh.

The tests run on the CPU (``JAX_PLATFORMS=cpu``) with 8 virtual devices
from XLA's host platform, so multi-device sharding is validated without a
GPU (SURVEY.md section 4). The platform is also forced through jax.config
before any backend is initialized. Tests that need the card carry the
``gpu`` marker and skip without one; on a GPU machine run them with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` (the rest of their
work is done by ``chip_smoke.py``).
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import pytest

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
# float64 available in tests so oracle comparisons can run the same code
# paths in both precisions (device code is dtype-polymorphic; fp32 tests
# pass explicit fp32 arrays).
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """The GPU for ``gpu``-marked tests; skips where there is none (decided
    here, at run time, never while test modules are imported)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/")
    return jax.devices()[0]
