"""Gossip-ensemble request loop: batch accumulation over live snapshots.

Counterpart of ``repro/launch/gossip_serve.py``. The server holds the
latest :class:`repro_torch.core.serving.QuerySnapshot` of a running
protocol and answers batches of feature-vector queries with the cache
majority vote (Algorithm 4 / Eq. 8 as a service). Wire it to an engine by
passing ``server.serve_hook`` (or a hook that calls it) as the
``serve_hook=`` of ``repro_torch.core.simulation.run_simulation``.

Request path: ``submit()`` accumulates queries; every full ``batch_size``
batch is answered at once (node assignment by the configured policy, then
``serve_voted_kernel``, and ``serve_fresh`` alongside for the
fresh-vs-voted comparison); ``flush()``
pads the tail to the batch shape and slices the answers back. The batch
latency is taken around the voted predict, ended by
``torch.cuda.synchronize()`` on a CUDA snapshot, and recorded in a
:class:`repro_torch.core.telemetry.LatencyHistogram`; ``stats()`` gives
queries/s and the p50/p90/p99/p999 batch latency from it. Pass
``telemetry=`` to share that histogram into the trace as
``serve_batch_latency`` and to record the snapshot adoptions and the
batches as ``snapshot_adopt`` and ``serve_batch`` spans on the "serving"
track.

Under a node mesh every rank runs a server of its own, fed its shard's
snapshot by the engine (``QuerySnapshot.shard``) and the same
submissions: the assignment draws from the global N, each rank answers
the queries its nodes own and one sum over the ranks combines the voted
and the fresh answers (``serving.serve_on_shards``), inside the latency
window. The cache is never gathered. ``answers()``, ``answers_fresh()``
and the counts of ``stats()`` are the one-device server's on every rank.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import serving
from repro_torch.core.telemetry import LatencyHistogram, Telemetry, maybe_span


@dataclass
class ServedBatch:
    """One answered batch: which snapshot served it and how fast."""
    cycle: int                 # protocol cycle of the serving snapshot
    size: int                  # real queries (the tail batch is padded)
    latency_s: float           # dispatch -> answers materialized
    query_ids: np.ndarray      # (size,) submission order ids
    assign: np.ndarray         # (size,) serving node per query
    preds: np.ndarray          # (size,) ±1 voted answers
    preds_fresh: np.ndarray    # (size,) PREDICT answers


@dataclass
class ServeStats:
    queries: int
    batches: int
    queries_per_sec: float
    p50_latency_s: float
    p99_latency_s: float
    serve_seconds: float
    p90_latency_s: float = 0.0
    p999_latency_s: float = 0.0
    latency_hist: Optional[dict] = None


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@dataclass
class GossipServer:
    """Holds the live snapshot; serves query batches.

    ``policy``: node assignment (``serving.ASSIGN_POLICIES``). Every batch
    is answered through the voted-predict kernel (its plain version for a
    CPU snapshot) and, outside the latency window, by the freshest-model
    PREDICT. For a fixed ``seed`` and submission order the answers are
    reproducible bit for bit. ``telemetry``, when armed, holds the
    server's histogram as ``serve_batch_latency`` and its spans."""
    batch_size: int = 256
    policy: str = "uniform"
    seed: int = 0
    telemetry: Optional[Telemetry] = None

    snapshot: Optional[serving.QuerySnapshot] = None
    snapshot_cycle: int = -1
    batches: List[ServedBatch] = field(default_factory=list)
    hist: LatencyHistogram = field(default_factory=LatencyHistogram)
    _pending_x: List[np.ndarray] = field(default_factory=list)
    _pending_ids: List[int] = field(default_factory=list)
    _next_id: int = 0
    _served: int = 0           # assignment-policy offset across batches

    def __post_init__(self):
        if self.telemetry is not None:
            self.telemetry.histograms["serve_batch_latency"] = self.hist

    def serve_hook(self, cycle: int, snapshot: serving.QuerySnapshot):
        """The ``serve_hook`` for ``run_simulation``: adopt the snapshot,
        waiting until the device has made it, so that the batch latency
        measures serving and not leftover simulation work."""
        with maybe_span(self.telemetry, "snapshot_adopt", track="serving",
                        cycle=int(cycle)):
            _sync(snapshot.w)
            self.snapshot = snapshot
            self.snapshot_cycle = int(cycle)

    def submit(self, X) -> None:
        """Accumulate queries (rows of X); answer every full batch."""
        X = np.asarray(X, np.float32)
        for row in X:
            self._pending_x.append(row)
            self._pending_ids.append(self._next_id)
            self._next_id += 1
            if len(self._pending_x) >= self.batch_size:
                self._serve_pending()

    def flush(self) -> None:
        """Answer the partial tail batch (padded to the batch shape)."""
        if self._pending_x:
            self._serve_pending()

    def _serve_pending(self) -> None:
        with maybe_span(self.telemetry, "serve_batch", track="serving"):
            self._serve_pending_inner()

    def _serve_pending_inner(self) -> None:
        if self.snapshot is None:
            raise RuntimeError("no snapshot yet — wire serve_hook into "
                               "run_simulation before submitting queries")
        k = min(len(self._pending_x), self.batch_size)
        xb = np.stack(self._pending_x[:k])
        ids = np.asarray(self._pending_ids[:k])
        del self._pending_x[:k], self._pending_ids[:k]
        if k < self.batch_size:                  # tail: pad, serve, slice
            xb = np.concatenate(
                [xb, np.zeros((self.batch_size - k, xb.shape[1]),
                              np.float32)])

        snap = self.snapshot
        assign = serving.assign_queries(
            self.batch_size, snap.n_nodes, policy=self.policy, seed=self.seed,
            offset=self._served)
        self._served += k
        dev = snap.w.device
        xt = torch.from_numpy(xb).to(dev)
        at = torch.from_numpy(assign).to(dev) if snap.shard is None else None
        _sync(xt)

        t0 = time.perf_counter()
        if at is not None:      # the reference's window: the voted answer
            preds = serving.serve_voted_kernel(snap.w, snap.count, xt, at)
            fresh = None
        else:                   # a shard: both answers and their sum
            preds, fresh = serving.serve_on_shards(snap, xt, assign)
        _sync(preds)
        dt = time.perf_counter() - t0
        self.hist.record(dt)

        if fresh is None:
            fresh = serving.serve_fresh(snap.fresh_w, xt, at)
        fresh = fresh.cpu().numpy()[:k]
        self.batches.append(ServedBatch(
            cycle=self.snapshot_cycle, size=k, latency_s=dt,
            query_ids=ids, assign=assign[:k],
            preds=preds.cpu().numpy()[:k], preds_fresh=fresh))

    def answers(self) -> np.ndarray:
        """All voted answers in submission order."""
        out = np.zeros(self._next_id, np.float32)
        for b in self.batches:
            out[b.query_ids] = b.preds
        return out

    def answers_fresh(self) -> np.ndarray:
        out = np.zeros(self._next_id, np.float32)
        for b in self.batches:
            out[b.query_ids] = b.preds_fresh
        return out

    def stats(self) -> ServeStats:
        """Queries/s and batch-latency percentiles from the histogram."""
        h = self.hist
        total = h.total
        q = int(sum(b.size for b in self.batches))
        return ServeStats(
            queries=q, batches=len(self.batches),
            queries_per_sec=q / total if total > 0 else 0.0,
            p50_latency_s=h.p50, p99_latency_s=h.p99,
            serve_seconds=total, p90_latency_s=h.p90,
            p999_latency_s=h.p999,
            latency_hist=h.to_dict() if h.count else None)
