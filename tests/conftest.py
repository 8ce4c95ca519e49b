import os

# Tests must see ONE device (only launch/dryrun.py forces 512). Keep any
# user-provided XLA_FLAGS but never the host-device override.
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" in flags:
    os.environ["XLA_FLAGS"] = " ".join(
        f for f in flags.split() if "host_platform_device_count" not in f)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
