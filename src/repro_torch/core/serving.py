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

Under a node mesh (the sharded engine's ``mesh=``) each rank holds the
nodes ``[lo, hi)`` of its block, and its snapshot is its shard's: the
rows of those nodes, with a :class:`SnapshotShard` saying where they sit
(``QuerySnapshot.shard``; None on one device). Nothing is gathered:
:func:`gather_snapshot` moves the whole population to a rank, for a hook
that asks for it. A query batch is served on the shards
(:func:`serve_on_shards`): the assignment is global and equal on every
rank, each rank answers the queries whose node it holds (kernel #5 on
its own cache rows at ``assign - lo``, and PREDICT), and one sum over
the ranks of each rank's answers in the others' zeros combines them.
Every answer has exactly one owner, so the combined answers are the
one-device answers bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import cache as cache_mod
from repro_torch.core.cache import ModelCache
from repro_torch.kernels.voted_predict import (voted_predict_batched,
                                               voted_predict_batched_plain)

ASSIGN_POLICIES = ("uniform", "round_robin")


class SnapshotShard(NamedTuple):
    """Where a rank's snapshot rows sit in the population: the nodes
    ``[lo, hi)`` of ``n``, block ``index`` of ``shards`` over the node
    axis ``axis`` (a ``sharding.compat.Axis``)."""
    lo: int
    hi: int
    index: int
    shards: int
    n: int
    axis: object


class QuerySnapshot(NamedTuple):
    """The serving-relevant protocol state at one cycle, owned by the
    snapshot (never aliasing the engine's tensors): every node's, or
    under a node mesh this rank's nodes' (``shard``)."""
    w: torch.Tensor        # (N, C, d) cache ring-buffer weights
    t: torch.Tensor        # (N, C) int32 per-slot update counters
    count: torch.Tensor    # (N,) int32 valid slots per node
    fresh_w: torch.Tensor  # (N, d) freshest model per node
    fresh_t: torch.Tensor  # (N,) int32
    clock: int             # engine clock at snapshot time
    shard: Optional[SnapshotShard] = None   # the rows' place under a mesh

    @property
    def n_nodes(self) -> int:
        """The population's N (the global N under a mesh)."""
        return self.count.shape[0] if self.shard is None else self.shard.n


# the reference's six fields
STATE_FIELDS = QuerySnapshot._fields[:6]


def _snapshot(cache: ModelCache, clock: int, shard=None) -> QuerySnapshot:
    fresh_w, fresh_t = cache_mod.freshest(cache)       # gathers: new tensors
    return QuerySnapshot(cache.w.clone(), cache.t.clone(),
                         cache.count.clone(), fresh_w, fresh_t, int(clock),
                         shard)


def take_snapshot(state) -> QuerySnapshot:
    """Snapshot of the reference engine's ``SimState`` (anything with
    ``.cache`` and ``.clock``)."""
    return _snapshot(state.cache, state.clock)


def snapshot_from_carry(carry, shard=None) -> QuerySnapshot:
    """Snapshot of the sharded engine's :class:`Carry`: its cache lanes and
    clock, equal to :func:`take_snapshot` of the reference engine at the
    same cycle. Under a node mesh ``shard`` (the engine's ``NodeShard``)
    places this rank's rows: the snapshot is its shard's."""
    where = None if shard is None else SnapshotShard(
        shard.lo, shard.hi, shard.index, shard.shards, shard.n, shard.axis)
    return _snapshot(carry.cache, carry.clock, where)


def gather_snapshot(snap: QuerySnapshot) -> QuerySnapshot:
    """The whole population's snapshot from every rank's shard (each rank
    calls it; one all-gather of the five lanes); a whole snapshot as it
    is. At N = 10^6, C = 10, d = 10 it moves about 490 MB to each rank."""
    sh = snap.shard
    if sh is None:
        return snap
    from repro_torch.sharding import compat
    lanes = compat.gather_rows(list(snap[:5]), [sh.hi - sh.lo] * sh.shards,
                               sh.axis)
    return QuerySnapshot(*lanes, snap.clock)



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


def serve_on_shards(snap: QuerySnapshot, X: torch.Tensor,
                    assign: np.ndarray):
    """The voted (kernel #5) and the fresh answers, (M,) ±1 each, to the
    queries ``X`` (M, d) at global nodes ``assign`` (numpy), from a
    shard's snapshot: this rank answers the queries whose node it holds
    on its rows (``assign - lo``), then one sum over the node axis of its
    answers in the other ranks' zeros gives every rank the whole batch's
    (the module note)."""
    from repro_torch.sharding import compat
    sh = snap.shard
    mine = np.flatnonzero((assign >= sh.lo) & (assign < sh.hi))
    out = torch.zeros((2, X.shape[0]), dtype=torch.float32, device=X.device)
    if mine.size:
        pos = torch.from_numpy(mine).to(X.device)
        at = torch.from_numpy((assign[mine] - sh.lo).astype(np.int32)).to(
            X.device)
        xm = X[pos].contiguous()
        out[0, pos] = serve_voted_kernel(snap.w, snap.count, xm, at)
        out[1, pos] = serve_fresh(snap.fresh_w, xm, at)
    both = compat.psum(out, sh.axis)
    return both[0], both[1]
