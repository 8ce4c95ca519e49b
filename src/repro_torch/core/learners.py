"""Online learners (Algorithm 3): Pegasos, Adaline, logistic regression.

Counterpart of ``repro/core/learners.py``, with the same op order. A linear
model is the pair ``(w, t)``; ``w`` may be ``(d,)`` or ``(N, d)`` with a
matching ``t``, and every rule is written point-wise over the population.
Labels are in {-1, +1}.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class LinearModel(NamedTuple):
    """The message payload of gossip learning: one linear model."""

    w: torch.Tensor          # (d,) or (N, d) float32
    t: torch.Tensor          # () or (N,) int32 update counter


def pegasos_update(m: LinearModel, x, y, lam: float) -> LinearModel:
    """UPDATEPEGASOS (Algorithm 3, lines 1–10): t <- t+1; eta = 1/(lam*t);
    w <- (1 - eta*lam) w + [margin < 1] eta*y*x."""
    t = m.t + 1
    eta = 1.0 / (lam * t.to(torch.float32))
    margin = y * torch.sum(m.w * x, dim=-1)
    decay = 1.0 - eta * lam
    if m.w.ndim == 2:
        decay = decay[:, None]
        eta = eta[:, None]
        hinge = (margin < 1.0)[:, None]
        yx = y[:, None] * x if torch.is_tensor(y) and y.ndim else y * x
    else:
        hinge = margin < 1.0
        yx = y * x
    w = decay * m.w + torch.where(hinge, eta * yx, 0.0)
    return LinearModel(w, t)


def adaline_update(m: LinearModel, x, y, eta: float) -> LinearModel:
    """UPDATEADALINE (Algorithm 3, lines 12–15): w += eta (y - <w,x>) x."""
    err = y - torch.sum(m.w * x, dim=-1)
    if m.w.ndim == 2:
        err = err[:, None]
    return LinearModel(m.w + eta * err * x, m.t + 1)


def logistic_update(m: LinearModel, x, y, eta: float,
                    lam: float = 0.0) -> LinearModel:
    """Logistic-loss SGD with L2 decay."""
    t = m.t + 1
    z = y * torch.sum(m.w * x, dim=-1)
    g = -y * torch.sigmoid(-z)
    if m.w.ndim == 2:
        g = g[:, None]
    w = (1.0 - eta * lam) * m.w - eta * g * x
    return LinearModel(w, t)


def make_update(learner: str, *, lam: float = 1e-4, eta: float = 0.01):
    if learner == "pegasos":
        return lambda m, x, y: pegasos_update(m, x, y, lam)
    if learner == "adaline":
        return lambda m, x, y: adaline_update(m, x, y, eta)
    if learner == "logistic":
        return lambda m, x, y: logistic_update(m, x, y, eta, lam)
    raise ValueError(f"unknown learner {learner!r}")
