"""Bounded model cache + local prediction (Algorithm 1 state, Algorithm 4).

Counterpart of ``repro/core/cache.py``: a ring buffer of the ``C`` most
recent models per node, PREDICT on the freshest one and VOTEDPREDICT by
majority over the valid slots (ties: ``score >= 0`` votes +1, and
``p_ratio - 0.5 >= 0`` predicts +1)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class ModelCache(NamedTuple):
    w: torch.Tensor        # (N, C, d) float32
    t: torch.Tensor        # (N, C) int32
    ptr: torch.Tensor      # (N,) int32 — next write slot
    count: torch.Tensor    # (N,) int32 — number of valid entries


def init_cache(n: int, c: int, d: int, device) -> ModelCache:
    """Cache initialized with the zero model in slot 0 (INITMODEL adds it)."""
    return ModelCache(
        w=torch.zeros((n, c, d), dtype=torch.float32, device=device),
        t=torch.zeros((n, c), dtype=torch.int32, device=device),
        ptr=torch.ones((n,), dtype=torch.int32, device=device),
        count=torch.ones((n,), dtype=torch.int32, device=device),
    )


def cache_add(cache: ModelCache, node_mask, w_new, t_new) -> ModelCache:
    """``modelCache.add`` on the subset ``node_mask`` of nodes (functional:
    returns a new cache, the input is not modified)."""
    n, c, _ = cache.w.shape
    rows = torch.arange(n, device=cache.w.device)
    slot = (cache.ptr % c).long()
    w = cache.w.clone()
    t = cache.t.clone()
    w[rows, slot] = torch.where(node_mask[:, None], w_new, cache.w[rows, slot])
    t[rows, slot] = torch.where(node_mask, t_new, cache.t[rows, slot])
    ptr = torch.where(node_mask, cache.ptr + 1, cache.ptr)
    count = torch.where(node_mask, torch.clamp_max(cache.count + 1, c),
                        cache.count)
    return ModelCache(w, t, ptr, count)


def freshest(cache: ModelCache):
    """``modelCache.freshest()`` — the most recently added model per node."""
    n, c, _ = cache.w.shape
    rows = torch.arange(n, device=cache.w.device)
    slot = ((cache.ptr - 1) % c).long()
    return cache.w[rows, slot], cache.t[rows, slot]


def cache_oldest(cache: ModelCache):
    """The oldest still-valid model per node (slot ``ptr - count``): what a
    ``stale_replay`` Byzantine node retransmits, with its counter."""
    n, c, _ = cache.w.shape
    rows = torch.arange(n, device=cache.w.device)
    slot = ((cache.ptr - cache.count) % c).long()
    return cache.w[rows, slot], cache.t[rows, slot]


def predict_fresh(cache: ModelCache, X):
    """PREDICT for every node over a test matrix X (m, d) -> (N, m) signs."""
    w, _ = freshest(cache)
    return torch.where(X @ w.T >= 0, 1.0, -1.0).T


def voted_predict(cache: ModelCache, X):
    """VOTEDPREDICT (Algorithm 4): majority vote over the valid cache slots;
    (N, m) predictions for every node on test matrix X (m, d)."""
    _, c, _ = cache.w.shape
    scores = torch.einsum("ncd,md->ncm", cache.w, X)
    votes = (scores >= 0).to(torch.float32)
    valid = (torch.arange(c, device=X.device)[None, :]
             < cache.count[:, None]).to(torch.float32)
    p_ratio = torch.einsum("ncm,nc->nm", votes, valid) / cache.count[:, None]
    return torch.where(p_ratio - 0.5 >= 0, 1.0, -1.0)
