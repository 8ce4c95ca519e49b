"""Live serving tier: query snapshots and batched voted prediction (Eq. 8).

Counterpart of ``repro/core/serving.py``. A :class:`QuerySnapshot` is a
read of the live engine state at an eval point (the cache ring and the
freshest model per node); queries are assigned to nodes by a host numpy
stream (``assign_queries``, never the protocol's threefry keys) and
answered by PREDICT (``serve_fresh``) or VOTEDPREDICT (``serve_voted``,
plain PyTorch, or ``serve_voted_kernel``, the voted-predict kernel).

JAX's arrays are immutable, so the reference's snapshot may alias the
engine state. The port's sharded engine updates its carry in place, so a
snapshot here is a **copy**: ``w``, ``t`` and ``count`` are cloned (and
``fresh_w``/``fresh_t`` gathered into new tensors). A snapshot held past
the engine's next chunk still answers from its own cycle, and serving
cannot perturb the run. At N = 10^6, C = 10, d = 10 the copy is about
490 MB a snapshot.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import cache as cache_mod
from repro_torch.core.cache import ModelCache
from repro_torch.kernels.voted_predict import (voted_predict_batched,
                                               voted_predict_batched_plain)

ASSIGN_POLICIES = ("uniform", "round_robin")


class QuerySnapshot(NamedTuple):
    """The serving-relevant protocol state at one cycle, owned by the
    snapshot (never aliasing the engine's tensors)."""
    w: torch.Tensor        # (N, C, d) cache ring-buffer weights
    t: torch.Tensor        # (N, C) int32 per-slot update counters
    count: torch.Tensor    # (N,) int32 valid slots per node
    fresh_w: torch.Tensor  # (N, d) freshest model per node
    fresh_t: torch.Tensor  # (N,) int32
    clock: int             # engine clock at snapshot time


def _snapshot(cache: ModelCache, clock: int) -> QuerySnapshot:
    fresh_w, fresh_t = cache_mod.freshest(cache)       # gathers: new tensors
    return QuerySnapshot(cache.w.clone(), cache.t.clone(),
                         cache.count.clone(), fresh_w, fresh_t, int(clock))


def take_snapshot(state) -> QuerySnapshot:
    """Snapshot of the reference engine's ``SimState`` (anything with
    ``.cache`` and ``.clock``)."""
    return _snapshot(state.cache, state.clock)


def snapshot_from_carry(carry) -> QuerySnapshot:
    """Snapshot of the sharded engine's :class:`Carry`: its cache lanes and
    clock, equal to :func:`take_snapshot` of the reference engine at the
    same cycle."""
    return _snapshot(carry.cache, carry.clock)


def assign_queries(n_queries: int, n_nodes: int, *,
                   policy: str = "uniform", seed: int = 0,
                   offset: int = 0) -> np.ndarray:
    """Node assignment for a query batch (int32): ``"uniform"`` draws from
    ``default_rng((seed, offset))``, ``"round_robin"`` is ``(offset + i) %
    n_nodes``."""
    if policy == "uniform":
        rng = np.random.default_rng((seed, offset))
        return rng.integers(0, n_nodes, n_queries).astype(np.int32)
    if policy == "round_robin":
        return ((offset + np.arange(n_queries)) % n_nodes).astype(np.int32)
    raise ValueError(f"unknown assignment policy {policy!r} "
                     f"(expected one of {ASSIGN_POLICIES})")


def serve_fresh(fresh_w, X, assign):
    """PREDICT for a query batch: the sign of ``<w_freshest, x>`` at the
    assigned node, the gathered form of ``cache.predict_fresh``."""
    w = fresh_w[assign.long()]                         # (M, d)
    return torch.where(torch.einsum("md,md->m", w, X) >= 0, 1.0, -1.0)


def serve_voted(w, count, X, assign):
    """VOTEDPREDICT for a query batch in plain PyTorch: the gathered rows
    of ``cache.voted_predict`` (``w`` (N, C, d), ``count`` (N,), ``X``
    (M, d), ``assign`` (M,) int32). Returns (M,) ±1."""
    a = assign.long()
    return voted_predict_batched_plain(w[a], count[a], X)


def serve_voted_kernel(w, count, X, assign):
    """VOTEDPREDICT for a query batch through the voted-predict kernel,
    which reads the assigned rows of the snapshot itself; its plain version
    on CPU tensors. Answers equal :func:`serve_voted`'s."""
    return voted_predict_batched(w, count, X, assign=assign)
