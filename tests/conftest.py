"""Test configuration: force an 8-virtual-device CPU mesh.

Tests run on the CPU (deterministic, fast, f64-capable for oracles) with 8
virtual devices, so the multi-device sharding paths run without a GPU. The
GPU is reached by `python chip_smoke.py` (`--four` for four GPUs) and
`python bench.py`, never by the tests.

The platform is pinned programmatically before any backend is created;
``jax_num_cpu_devices`` replaces the XLA_FLAGS host-device-count flag (which
is only parsed at process startup and cannot be set this late).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
try:  # If a backend was already created (an earlier import), drop it.
    if jax.default_backend() != "cpu" or len(jax.devices()) != 8:
        from jax.extend import backend as _jex_backend

        _jex_backend.clear_backends()
except Exception:
    pass

assert jax.default_backend() == "cpu", "tests must run on the CPU backend"
assert len(jax.devices()) == 8, "tests expect 8 virtual CPU devices"

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
