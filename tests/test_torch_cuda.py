"""The port's CUDA kernels on the card, against their plain versions: the
receive kernel on the f32 wire and in every decode mode, the send kernels
of the quantized codecs (bitwise), and the sharded engine against the
reference engine on the f32 and the quantized wires.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one. They import neither JAX nor the JAX package, so they run on a
machine with only PyTorch: ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``. The inputs and comparisons are
``chip_smoke.py``'s own, at other shapes and seeds."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import random
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
@pytest.mark.parametrize("mode", sorted(smoke.DECODE_WIRES))
@pytest.mark.parametrize("variant", ["rw", "mu", "um"])
def test_receive_kernel_decodes_like_plain_version(cuda, variant, mode):
    """Each decode mode at d = 57 with K > C: integer state equal, float
    state within rtol 1e-5 and atol 1e-5."""
    base = smoke.receive_inputs(11, 2003, 57, 3, 5, cuda,
                                wire=smoke.DECODE_WIRES[mode])
    before = gc.fused_receive_apply.launches
    smoke.compare_kernel(base, variant, 1e-3, 1e-5,
                         wire=smoke.DECODE_WIRES[mode])
    assert gc.fused_receive_apply.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 7, 10, 57, 9947])
@pytest.mark.parametrize("name", smoke.SEND_CODECS)
def test_send_kernel_matches_plain_version_bitwise(cuda, name, d):
    n = 1031 if d < 1000 else 129
    w, ef = smoke.send_inputs(d, n, d, cuda)
    kernel = gc.send_kernel_name(name)
    before = gc.quantize_send.launches[kernel]
    smoke.compare_send(name, w, ef, random.key(d, device=cuda))
    assert gc.quantize_send.launches[kernel] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("wire", [None, *smoke.MAIN_WIRES])
def test_sharded_engine_with_kernel_matches_reference_engine(cuda, wire):
    n = 2000
    X, y = make_linear_dataset(np.random.default_rng(0), n + 500, 10,
                               noise=0.07, separation=2.5)
    cfg = with_failure_scenario(GossipLinearConfig(
        name="cuda-test", dim=10, n_nodes=n, n_test=500, class_ratio=(1, 1),
        lam=1e-3, variant="mu"), "extreme")
    smoke.compare_engines(dataclasses.replace(cfg, wire_dtype=wire), X, y,
                          n, cuda, cycles=12, eval_every=6, seed=1)
