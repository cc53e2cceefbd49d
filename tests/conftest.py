"""Test configuration.

By default the whole suite runs on a simulated 8-device CPU mesh: all
sharded-path tests (DB sharding, all-gather top-k merge) run under
`--xla_force_host_platform_device_count=8`. The math is placement-invariant;
CPU also makes the suite fast and deterministic.

Tests marked `gpu` need a real card. They skip here (the `gpu_device`
fixture decides, at run time), and run on a GPU machine with

    HPFW_TEST_PLATFORM=gpu python -m pytest -m gpu tests/test_gpu_kernels.py -q

HPFW_TEST_PLATFORM=gpu leaves the platform to JAX (it picks the card).
The platform setup below must run before jax is imported anywhere.
"""

import os

if os.environ.get("HPFW_TEST_PLATFORM", "cpu") == "cpu":
    # No persistent compile cache in CPU tests: compiles are fast and the
    # cache would be written into the checkout.
    os.environ["HPFW_NO_COMPILE_CACHE"] = "1"
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import numpy as np
import pytest

from hpfw_jax.config import HpfwConfig


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU; skips the test when JAX finds none."""
    import jax

    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run with HPFW_TEST_PLATFORM=gpu on a "
                    "machine with one)")
    return devs[0]


@pytest.fixture(scope="session")
def cfg():
    """Small config for fast tests: same structure, shorter frames.

    frame_len 2048 requires raising fmin so the longest CQT kernel fits
    (N_max = Q*sr/fmin <= 2048 -> fmin >= ~368 Hz); 3 octaves at 24 b/o.
    """
    return HpfwConfig(frame_len=2048, fmin=380.0, n_bins=73, hop=256,
                      context_w=8, delta_lag=4, db_downsample=4)


@pytest.fixture(scope="session")
def full_cfg():
    """The production default config (slow — use sparingly)."""
    return HpfwConfig()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)
