"""Evaluation metrics used by the paper's experimental section.

Counterpart of ``repro/utils/metrics.py``:

- 0-1 error (misclassification ratio), the paper's primary metric, of a
  model, a population, a vote and a weighted vote;
- pairwise cosine similarity of the model population (Fig. 2 bottom row);
- Welford online mean/variance for streaming bench statistics.

The scores ``X @ W.T`` are float32 products on the tensors' device (no
TF32: the reference computes them in full float32); the error rates are
``mean_of_mask``, the reference's float32 mean bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def mean_of_mask(mask, dim=None) -> torch.Tensor:
    """The share of true entries of a bool ``mask`` (along ``dim``, or of
    all) in float32, as ``jnp.mean`` of it computes under XLA, bit for bit:
    the exact count times the float32 reciprocal of the length."""
    n = mask.numel() if dim is None else mask.shape[dim]
    count = mask.sum() if dim is None else mask.sum(dim=dim)
    return count.to(torch.float32) * float(np.float32(1) / np.float32(n))


def _error(preds, y) -> torch.Tensor:
    return mean_of_mask(preds != y, dim=0)


def zero_one_error(w, X, y, bias=None) -> torch.Tensor:
    """Misclassification ratio of linear model(s) ``w`` on test set (X, y).

    ``w`` may be a single (d,) model or a (m, d) population; returns a
    0-dim tensor or an (m,) vector respectively. Labels are in {-1, +1}.
    """
    scores = X @ w.T if w.ndim == 2 else X @ w
    if bias is not None:
        scores = scores + bias
    preds = torch.where(scores >= 0, 1.0, -1.0)
    if w.ndim == 2:
        return _error(preds, y[:, None])
    return _error(preds, y)


def voted_error(W, X, y) -> torch.Tensor:
    """0-1 error of majority voting over a model cache ``W`` of shape
    (c, d): VOTEDPREDICT (Algorithm 4), each cached model voting by the
    sign of its score, the prediction the majority sign."""
    p_ratio = mean_of_mask(X @ W.T >= 0, dim=1)        # share of + votes
    preds = torch.where(p_ratio - 0.5 >= 0, 1.0, -1.0)
    return _error(preds, y)


def weighted_vote_error(W, X, y) -> torch.Tensor:
    """0-1 error of the *weighted* vote sgn(Σ⟨w_i, x⟩): Eqs. (7), (18),
    (19)."""
    scores = X @ W.T                                   # (n, m)
    preds = torch.where(scores.sum(dim=1) >= 0, 1.0, -1.0)
    return _error(preds, y)


def cosine_similarity(W: torch.Tensor) -> torch.Tensor:
    """Mean pairwise cosine similarity across the model population (m, d)."""
    norms = torch.linalg.vector_norm(W, dim=1, keepdim=True)
    Wn = W / torch.clamp_min(norms, 1e-12)
    G = Wn @ Wn.T
    m = W.shape[0]
    return (G.sum() - torch.trace(G)) / (m * (m - 1))


class Welford:
    """Streaming mean/std (host-side, for the drivers' statistics)."""

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def add(self, x: float) -> None:
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)

    @property
    def std(self) -> float:
        return (self.m2 / self.n) ** 0.5 if self.n > 1 else 0.0
