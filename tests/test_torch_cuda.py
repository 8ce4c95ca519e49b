"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one. They import neither JAX nor the JAX package, so they run on a
machine with only PyTorch: ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``. The inputs and comparisons are
``chip_smoke.py``'s own, at other shapes and seeds."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.gossip_linear import (GossipLinearConfig,
                                               with_failure_scenario)
from repro_torch.data.synthetic import make_linear_dataset
from repro_torch.kernels import gossip_cycle as gc

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,c,k", [(4099, 57, 10, 4), (257, 16, 3, 5),
                                     (64, 9947, 10, 4)])
@pytest.mark.parametrize("variant", ["rw", "mu", "um"])
def test_receive_kernel_matches_plain_version(cuda, variant, n, d, c, k):
    """Integer state equal; float state within rtol 1e-5 and atol 1e-5
    (1e-4 at d = 9947: the margin is summed in another order)."""
    base = smoke.receive_inputs(n + d, n, d, c, k, cuda)
    before = gc.fused_receive_apply.launches
    smoke.compare_kernel(base, variant, 1e-3, 1e-4 if d > 1000 else 1e-5)
    assert gc.fused_receive_apply.launches == before + 1


@pytest.mark.cuda
def test_sharded_engine_with_kernel_matches_reference_engine(cuda):
    n = 2000
    X, y = make_linear_dataset(np.random.default_rng(0), n + 500, 10,
                               noise=0.07, separation=2.5)
    cfg = with_failure_scenario(GossipLinearConfig(
        name="cuda-test", dim=10, n_nodes=n, n_test=500, class_ratio=(1, 1),
        lam=1e-3, variant="mu"), "extreme")
    smoke.compare_engines(cfg, X, y, n, cuda, cycles=12, eval_every=6,
                          seed=1)
