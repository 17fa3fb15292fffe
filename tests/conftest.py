"""Test configuration: run JAX on CPU with 8 virtual devices.

Mirrors the reference's strategy of testing distributed code paths without a
cluster (SparkSessionTestWrapper.scala:24-46 uses local[*] with tiny input
splits); here an 8-device host-platform mesh exercises the sharded paths.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# CPU unless the caller picked another platform (tests/test_gpu.py runs with
# JAX_PLATFORMS=cuda). The persistent compile cache stays off for CPU runs
# (utils.enable_compile_cache says why).
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)
