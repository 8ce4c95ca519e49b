"""Evaluation metrics (counterpart of ``repro/utils/metrics.py``)."""
from __future__ import annotations

import torch


def cosine_similarity(W: torch.Tensor) -> torch.Tensor:
    """Mean pairwise cosine similarity across the model population (m, d)."""
    norms = torch.linalg.vector_norm(W, dim=1, keepdim=True)
    Wn = W / torch.clamp_min(norms, 1e-12)
    G = Wn @ Wn.T
    m = W.shape[0]
    return (G.sum() - torch.trace(G)) / (m * (m - 1))
