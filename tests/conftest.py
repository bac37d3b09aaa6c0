"""Test configuration.

The platform is left to `JAX_PLATFORMS`: tests run on the CPU with
`JAX_PLATFORMS=cpu`, where the multi-device sharding tests get 8 virtual
CPU devices from the XLA flag set here before JAX starts. Tests marked
`chip` need a GPU; the `gpu` fixture skips them anywhere else.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from tracer_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable(min_compile_secs=0.5)


@pytest.fixture
def rng_np():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (tests marked chip)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run on the card with "
                    "`python -m pytest tests/ -m chip`")


@pytest.fixture
def devices8():
    """Skip unless 8 devices are visible (the CPU run's virtual mesh)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
