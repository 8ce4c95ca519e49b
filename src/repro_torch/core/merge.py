"""MERGE and the three CREATEMODEL variants (Algorithm 2 + Algorithm 3).

Counterpart of ``repro/core/merge.py``."""
from __future__ import annotations

import torch

from repro_torch.core.learners import LinearModel


def merge(m1: LinearModel, m2: LinearModel) -> LinearModel:
    """MERGE (Algorithm 3, lines 22–26): w = (w1+w2)/2, t = max(t1,t2)."""
    return LinearModel((m1.w + m2.w) / 2.0, torch.maximum(m1.t, m2.t))


def create_model_rw(update, m1: LinearModel, m2: LinearModel, x, y):
    """CREATEMODELRW: independent random walk — update(m1)."""
    del m2
    return update(m1, x, y)


def create_model_mu(update, m1: LinearModel, m2: LinearModel, x, y):
    """CREATEMODELMU: merge, then update — update(merge(m1, m2))."""
    return update(merge(m1, m2), x, y)


def create_model_um(update, m1: LinearModel, m2: LinearModel, x, y):
    """CREATEMODELUM: update both with the local example, then merge."""
    return merge(update(m1, x, y), update(m2, x, y))


VARIANTS = {
    "rw": create_model_rw,
    "mu": create_model_mu,
    "um": create_model_um,
}


def create_model(variant: str, update, m1, m2, x, y) -> LinearModel:
    return VARIANTS[variant](update, m1, m2, x, y)
