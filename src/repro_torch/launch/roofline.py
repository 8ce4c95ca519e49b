"""Roofline terms of a step, counted on ``meta`` tensors.

Counterpart of ``repro/launch/roofline.py``. Three terms a step, in
seconds:

    compute    = flops / (chips x PEAK_FLOPS_BF16)
    memory     = bytes / (chips x HBM_BW)
    collective = wire bytes / NVLINK_BW

The reference reads flops and bytes off XLA's ``cost_analysis()`` of the
compiled step. A PyTorch program has no compiled artifact, so
:func:`analyze` runs the step's function itself on ``meta`` tensors
(``launch/specs.py``'s ``input_specs``, ``transformer.abstract_params``),
which carry shapes and dtypes and allocate nothing:

- flops: ``torch.utils.flop_counter.FlopCounterMode`` (matmuls, batched
  matmuls, convolutions and attention products; element-wise ops count 0,
  as in XLA's count of a fused graph's dots);
- bytes: every dispatched aten op's operand and result bytes, a view's
  none (:class:`BytesCounter`). Each op reads and writes memory as if
  nothing were fused, so this is an upper bound of the traffic, not XLA's
  count after fusion;
- collective bytes: 0 on one device. ``parse_collectives`` reads XLA's
  HLO text, which a PyTorch program never produces; the port counts its
  own collectives as they are issued (``sharding.compat.STATS``, a
  :class:`CollectiveStats`, by the reference's algorithm-aware rules).

A model runs on ``meta`` only where no kernel needs a device:
``attn_impl="xla"`` (full attention) or ``"banded"`` (windowed), as the
reference's ``costs.py`` chooses for its loop-free count. Kernel #8
(``"flash"``) has no ``meta`` route and raises there.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16


@dataclass
class CollectiveStats:
    per_op: Dict[str, int] = field(default_factory=dict)      # op -> operand bytes
    count: Dict[str, int] = field(default_factory=dict)
    total_operand_bytes: int = 0                              # per device
    wire_bytes: int = 0                                       # per device, algo-aware


@dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    wire_bytes_per_device: float
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    collectives: Dict[str, int]
    collective_counts: Dict[str, int]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class BytesCounter(TorchDispatchMode):
    """Sums the bytes of every dispatched aten op's tensor operands and
    results (``bytes``), leaving out views, which move nothing. A tensor
    that is not on ``meta`` raises, but for a 0-d host scalar (a
    constant the model computes on the host): the count allocates
    nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        tensors = [t for t in tree_leaves((args, kwargs, out))
                   if isinstance(t, torch.Tensor)]
        on_host = [t for t in tensors if t.device.type != "meta"]
        if any(t.dim() > 0 for t in on_host):
            raise ValueError(f"{func}: the count runs on meta tensors only, "
                             f"got one on {on_host[0].device}")
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in tensors
                              if t.device.type == "meta")
        return out


def count(fn: Callable, *args, **kwargs) -> Tuple[int, int, object]:
    """Run ``fn(*args, **kwargs)`` on ``meta`` tensors under the two
    counters. Returns (flops, bytes, fn's result)."""
    flops = FlopCounterMode(display=False)
    nbytes = BytesCounter()
    with flops, nbytes:
        out = fn(*args, **kwargs)
    return flops.get_total_flops(), nbytes.bytes, out


def analyze(fn: Callable, *args, chips: int = 1, model_flops: float = 0.0,
            **kwargs) -> Roofline:
    """The roofline of one call of ``fn`` on ``meta`` inputs (the
    counterpart of the reference's ``analyze(compiled, ...)``; see the
    module note for what each count holds)."""
    flops, nbytes, _ = count(fn, *args, **kwargs)
    coll = CollectiveStats()
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = nbytes / HBM_BW
    collective_s = coll.wire_bytes / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    useful = model_flops / (flops * chips) if flops > 0 else 0.0
    return Roofline(
        flops_per_device=float(flops),
        bytes_per_device=float(nbytes),
        collective_bytes_per_device=float(coll.total_operand_bytes),
        wire_bytes_per_device=float(coll.wire_bytes),
        chips=chips,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops,
        useful_ratio=useful,
        collectives=coll.per_op,
        collective_counts=coll.count,
    )


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) per step.

    D = tokens processed: global_batch×seq for train/prefill, global_batch
    for one decode step. Train counts fwd+bwd (the 6); inference counts 2·N·D."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n_active * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n_active * toks
    return 2.0 * n_active * shape.global_batch
