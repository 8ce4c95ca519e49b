"""Learning-rate schedules (pure functions of the step counter).

Counterpart of ``repro/optim/schedules.py``. A step is a Python int or a
0-d tensor; each schedule returns a 0-d float32 tensor (on the step's
device) computed in the reference's op order. Divisions by or of a
constant divide tensors: PyTorch turns ``number / tensor`` (and, in its
CUDA kernels, ``tensor / number``) into a multiply by a reciprocal.
"""
from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32, device=like.device)


def constant(lr: float):
    def sched(step):
        dev = step.device if isinstance(step, torch.Tensor) else None
        return torch.tensor(lr, dtype=torch.float32, device=dev)
    return sched


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def sched(step):
        step = _step_f32(step)
        warm = lr * torch.minimum(step / _f32(max(warmup_steps, 1), step),
                                  _f32(1.0, step))
        prog = torch.clamp((step - warmup_steps)
                           / _f32(max(total_steps - warmup_steps, 1), step),
                           0.0, 1.0)
        cos = (final_frac * lr + (1 - final_frac) * lr * 0.5
               * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return sched


def pegasos_schedule(lam: float):
    """η_t = 1/(λ t) — the Pegasos step size the paper's learner uses."""
    def sched(step):
        t = torch.clamp(_step_f32(step), min=1.0)
        return torch.div(_f32(1.0, t), lam * t)
    return sched
