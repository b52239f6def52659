"""Test rig: force the CPU platform with 8 virtual devices BEFORE jax initialises.

The TPU-equivalent of the reference's 2-process gloo pool
(``tests/unittests/conftest.py:26-84``): distributed semantics are exercised on an
8-device host-platform mesh via ``shard_map`` (SURVEY §4.3).
"""

import os

os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import pytest  # noqa: E402

NUM_DEVICES = 8
NUM_BATCHES = 4
BATCH_SIZE = 32
NUM_CLASSES = 5
EXTRA_DIM = 3
THRESHOLD = 0.5


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: acceptance-scale runs excluded from the tier-1 `-m 'not slow'` pass"
    )
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one (run with -m cuda on the card)")


@pytest.fixture(autouse=True)
def _seed_everything():
    import numpy as np

    np.random.seed(42)
    yield
