"""Test configuration — mirrors the reference strategy (test/conftest.py):
force CPU with 8 virtual devices (so multi-device sharding paths are
exercised without accelerator hardware), fixed seeds per test.

NB: pytest plugins (flax/chex) may import jax before this file runs, so the
env vars alone are not enough — we also set the config keys, which work any
time before first backend initialization.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault(
    "XLA_FLAGS",
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8",
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from numpyro_tpu.util import set_rng_seed  # noqa: E402

assert jax.devices()[0].platform == "cpu", (
    "tests must run on CPU; got " + repr(jax.devices())
)


@pytest.fixture(autouse=True)
def _seed_rngs():
    set_rng_seed(0)
    yield


def pytest_addoption(parser):
    parser.addoption(
        "--runslow",
        action="store_true",
        default=False,
        help="also run tests marked slow (long statistical checks, examples)",
    )


# Whole modules whose tests are long statistical / multi-process checks:
# the default `pytest tests/ -q` is a fast lane (target: <10 min on one
# core); these run under --runslow, which CI executes in a dedicated job
# every round alongside the per-test slow marks.
_SLOW_MODULES = {
    "test_multihost",            # spawns a 2-process jax.distributed run
    "test_pooled_adaptation",
    "test_batched_samplers",     # chi-square/KS statistical checks
    "test_smc",
    "test_chees",
    "test_reparam",
    "test_mass_adaptation",
    "test_autoguide_extra",
    "test_kernels",              # per-kernel posterior-moment sweeps
    "test_mixed_hmc",
    "test_einstein",             # SteinVI particle-flow statistical checks
    "test_distributions_structured",  # structured-family statistical checks
    "test_nested_sampling",
    "test_hsgp",
}


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow test: pass --runslow to include")
    for item in items:
        if (
            "slow" in item.keywords
            or item.module.__name__.split(".")[-1] in _SLOW_MODULES
        ):
            item.add_marker(skip_slow)
