"""The public entry points of kernels #6, #7 and #8.

Counterpart of ``repro/kernels/ops.py``. Each call dispatches on the
tensors' device, as ``kernels/gossip_cycle.py`` does: CUDA tensors go to
the hand-written kernel (``csrc/pegasos_merge.cu``; for attention
``csrc/flash_attention_hopper.cu`` or ``csrc/flash_attention.cu``, as
``flash_attention.route`` decides), CPU tensors to its plain PyTorch
version.
There is no ``interpret`` argument and no fallback on CUDA; the launch
counts are on the wrappers in ``pegasos_update``, ``gossip_merge`` and
``flash_attention``.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gossip_merge as _gm
from repro_torch.kernels import pegasos_update as _pu


def pegasos_update(w, t, x, y, *, lam: float):
    return _pu.pegasos_update(w, t, x, y, lam=lam)


def merge_update(w1, t1, w2, t2, x, y, *, lam: float):
    return _gm.merge_update(w1, t1, w2, t2, x, y, lam=lam)


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    return _fa.flash_attention(q, k, v, causal=causal, window=window)
