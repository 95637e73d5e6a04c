"""Test configuration: force JAX onto CPU with 8 virtual devices.

Tests run on the CPU; sharding/mesh tests run on a virtual 8-device CPU mesh
(the rehearsal of the multi-device path). Tests that need a GPU are marked
``gpu`` and take the ``gpu`` fixture, which skips them on the CPU. On a GPU
machine run them with ``MPC_IRIS_TESTS_ON_GPU=1 python -m pytest -m gpu
tests/``, which leaves the platform to JAX. Must run before any jax import
in the test process.
"""

import os

ON_GPU = os.environ.get("MPC_IRIS_TESTS_ON_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
# Tests (and their bench.py subprocesses) must never append to the bench
# history ledger (docs/BENCH_HISTORY.jsonl).
os.environ["MPC_IRIS_NO_BENCH_HISTORY"] = "1"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Pin the platform in jax.config too, before any backend initializes (a config
# value set elsewhere would override the environment variable).
import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

# Persistent compile cache: XLA compiles dominate the suite's wall time; a warm
# cache cuts repeat runs to minutes. Same directory rule as every entry point.
from mpc_iris_tpu.utils.config import enable_compile_cache

enable_compile_cache()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0xC0FFEE)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none. Decided at
    run time, never at import, so every xdist worker collects the same
    tests."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run with the gpu marker on the card)")
    return devs[0]
