"""Test env: force CPU with 8 virtual devices.

SURVEY.md §4 "Distributed" row: multi-host behavior is simulated with
`--xla_force_host_platform_device_count=8`; all tests must pass on CPU.
JAX_PLATFORMS is set and the jax config pinned to cpu before any backend
initializes, so a machine with a GPU still runs the suite on the CPU.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    )
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

assert jax.devices()[0].platform == "cpu", (
    "tests must run on CPU; got " + str(jax.devices())
)
assert jax.device_count() == 8, "expected 8 virtual CPU devices"


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
