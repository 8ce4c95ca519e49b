"""Mega-population gossip engine (``run_simulation(engine="sharded")``).

Counterpart of ``repro/core/sharded_engine.py``, on one device or over a
node mesh of ranks (``mesh=``, :class:`NodeShard`), with its three
packings, on every wire codec, learner and fault model, with the defense
screens and a ``serve_hook`` at every eval point. The protocol is split
the way a router splits a network:

* **control plane on the host**: which message reaches which node in which
  round depends only on the threefry draws, the churn matrix and the
  delay/drop outcomes. The engine draws each cycle's destinations and
  arrivals on the device with the same threefry calls as the reference
  engine (``_draw_chunk``), pulls the integer tables to the host and
  resolves the K winner rounds in numpy (``_HostRouter``, a copy of the
  reference's), which also lists each cycle's round-1 and round-2
  receivers. The message economy falls out of the same pass.
* **the packing**: per chunk the engine picks, from those lists, the
  cheapest of the reference's three packings with its cost model:
  ``dense`` (the (T, K, N) table, K rounds over all N), ``compact`` (round
  1 dense, rounds 2..K over the padded list of round-2 receivers) or
  ``compact_all`` (every round over the padded list of round-1 receivers,
  and the send over the senders alone), and builds the tables it reads
  (``dense_table``, ``pack_compact_rounds``, ``pack_compact_all``).
* **data plane on the device**: per chunk of cycles between two eval
  points, a Python loop over the chunk's cycles (the reference's
  ``lax.scan``) gathers the winning payloads (in the wire codec's
  representation, with their scale and zero-point) and applies the
  receives, over all N or over a gathered subset whose real rows are
  scattered back. For Pegasos the apply is the fused receive kernel
  (``repro_torch.kernels.gossip_cycle``; its plain version on CPU
  tensors), which decodes the payloads; for the other learners it is the
  vector apply (``_vector_apply``), plain PyTorch on both devices, as the
  reference runs its vector apply for them on every backend. Then each
  node's freshest model, encoded by the send kernel (``quantize_send``)
  for the quantized codecs, refreshes the in-flight buffer row, or under
  ``compact_all`` only the senders' slots of it. The carry is updated in
  place, as the JAX chunk function donates it. A Byzantine sender's model
  is corrupted before the encode (or its payload after it) with the
  cycle's ``fault_key``, made on the device for the whole chunk. Launches
  are asynchronous, so routing chunk i+1 on the host overlaps the device's
  work on chunk i; the eval results and the screen's counts are read once,
  after the last chunk. Byzantine sends are counted on the host from the
  arrival table, as the reference's host loop counts them.

Determinism: the same seed gives the same host stream, the same per-cycle
draws and the same winner semantics as both reference engines, so the
economy is exactly theirs and the curves agree. Every packing gives the
dense packing's bits, but where a screen's sum order depends on the row
count it sums (5 <= d <= 8, ``faults.screen_split``): there the subset
apply sums over its padded width, as the reference's does.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import random
from repro_torch.configs.gossip_linear import GossipLinearConfig
from repro_torch.core import cache as cache_mod
from repro_torch.core import faults, serving
from repro_torch.core.cache import ModelCache
from repro_torch.core.learners import LinearModel, make_update
from repro_torch.core.merge import create_model
from repro_torch.core.simulation import (SimResult, _eval, byzantine_tensor,
                                         check_slice, draw_sends,
                                         ef_residual_norm, ef_residual_rms,
                                         ef_squares, eval_points,
                                         message_wire_bytes,
                                         payload_buffer_bytes, sim_setup)
from repro_torch.core.telemetry import maybe_span
from repro_torch.core.wire_codec import WireCodec, get_codec
from repro_torch.kernels import gossip_cycle
from repro_torch.sharding import compat
from repro_torch.utils.device import resolve_device


def key_schedule(seed: int, cycles: int, device) -> torch.Tensor:
    """The reference driver's per-cycle subkeys as one (cycles, 2) tensor:
    bitwise ``for c: key, sub = split(key)``."""
    k = random.key(seed, device=device)
    subs = []
    for _ in range(cycles):
        k, sub = random.split(k)
        subs.append(sub)
    return torch.stack(subs)


def recv_keys(keys) -> torch.Tensor:
    """(T, 2) cycle keys -> (T, 2) ``k_recv = split(key, 4)[0]`` of each,
    on the keys' device: slot 0 of the split hashes the counter (0, 0)."""
    zero = torch.zeros_like(keys[:, 0])
    b1, b2 = random.threefry2x32(keys[:, 0], keys[:, 1], zero, zero)
    return torch.stack([b1, b2], dim=-1)


def _draw_chunk(keys, onlines, clock0: int, *, n: int, drop: float,
                delay_max: int, sampler: str):
    """(T, 2) keys and (T, n) online rows -> (T, n) int32 destination and
    arrival tables, on the keys' device: the per-cycle draw sequence of
    ``cycle_core``, bit for bit."""
    dsts, arrivals = [], []
    for t in range(keys.shape[0]):
        dst, arr = draw_sends(keys[t], n, clock0 + t, onlines[t], drop=drop,
                              delay_max=delay_max, sampler=sampler)
        dsts.append(dst)
        arrivals.append(arr)
    return torch.stack(dsts), torch.stack(arrivals)


class _HostRouter:
    """Host-side control-plane state, carried between chunks as three flat
    int32 pending arrays: flat slot id (row*n + sender), destination and
    absolute arrival cycle, snapshotted at send time (a slot row is never
    overwritten before its arrival cycle's deliveries run)."""

    def __init__(self, delay_max: int):
        self.delay_max = delay_max
        self.p_slot = _EMPTY_I32
        self.p_dst = _EMPTY_I32
        self.p_arr = _EMPTY_I32

    def route_chunk(self, dsts, arrivals, online_rows, clock0: int,
                    k_rounds: int, per_cycle_stats: bool = False):
        """Resolve winner-per-destination rounds for a chunk of cycles, in
        one batched numpy pass: every candidate message arriving inside the
        chunk is ranked within its (cycle, destination) group by descending
        flat slot id, and rank r < K receives in round r — the semantics of
        ``select_receivers``.

        Returns ``(win, stats, multi, recv)``: the winner tuple ``(t,
        round, dst, slot)`` of parallel int32 arrays, ascending in (t,
        dst); the chunk's message economy with ``delivered_cycles``, the
        (T,) per-cycle delivered counts; and, a list a cycle, the ascending
        int32 node ids that receive in round 2 (``multi``; winner rounds
        fill in order, so they include every deeper round's) and in round 1
        (``recv``, every receiver).

        ``per_cycle_stats`` (armed telemetry only) adds the (T,) per-cycle
        ``lost_cycles`` and ``overflow_cycles``, both counted at the
        arrival cycle as the reference engine counts them."""
        T, n = dsts.shape
        D, K = self.delay_max, k_rounds

        t_send, senders = np.nonzero(arrivals >= 0)
        slot = (((clock0 + t_send) % D) * n + senders).astype(np.int32)
        sent = int(senders.size)
        cand_slot = np.concatenate([self.p_slot, slot])
        cand_dst = np.concatenate([self.p_dst,
                                   dsts[t_send, senders].astype(np.int32)])
        cand_arr = np.concatenate([self.p_arr,
                                   arrivals[t_send, senders].astype(np.int32)])
        future = cand_arr >= clock0 + T
        self.p_slot = cand_slot[future]
        self.p_dst = cand_dst[future]
        self.p_arr = cand_arr[future]
        due = ~future
        c_slot = cand_slot[due]
        c_dst = cand_dst[due]
        c_t = cand_arr[due] - clock0

        # a message due while its destination is offline leaves the system
        on = online_rows[c_t, c_dst]
        lost = int(c_slot.size - int(on.sum()))
        lost_t = c_t[~on] if per_cycle_stats else None
        c_slot, c_dst, c_t = c_slot[on], c_dst[on], c_t[on]

        # sort by (cycle, dst) group, ascending slot id inside each group:
        # rank-from-group-end r is the r-th largest slot id
        group = c_t.astype(np.int64) * n + c_dst
        order = np.lexsort((c_slot, group))
        g_s = group[order]
        t_s, dst_s = c_t[order], c_dst[order]
        rank = np.searchsorted(g_s, g_s, side="right") - 1 \
            - np.arange(g_s.size)
        wm = rank < K
        win = (t_s[wm].astype(np.int32), rank[wm].astype(np.int32),
               dst_s[wm], c_slot[order][wm])
        delivered = int(wm.sum())

        def ids_by_cycle(mask):
            # groups ascend in (cycle, dst): each cycle's ids ascend
            tm, dm = t_s[mask], dst_s[mask]
            return [a.astype(np.int32, copy=False) for a in
                    np.split(dm, np.searchsorted(tm, np.arange(1, T)))]

        recv = ids_by_cycle(rank == 0)
        multi = ids_by_cycle(rank == 1) if K > 1 else [_EMPTY_I32] * T
        stats = dict(sent=sent, delivered=delivered, lost=lost,
                     overflow=int(g_s.size - delivered),
                     delivered_cycles=np.bincount(
                         win[0], minlength=T).astype(np.int64))
        if per_cycle_stats:
            per_cycle = lambda t: np.bincount(t, minlength=T).astype(np.int64)
            stats["lost_cycles"] = per_cycle(lost_t)
            stats["overflow_cycles"] = per_cycle(t_s[~wm])
        return win, stats, multi, recv

    @property
    def in_flight(self) -> int:
        """Messages sent but not yet due."""
        return int(self.p_slot.size)


_EMPTY_I32 = np.empty(0, np.int32)


def shard_list_width(lists, n: int, shards: int) -> int:
    """Smallest per-shard width that fits every per-cycle index list: the
    longest list on one shard; under a node mesh of ``shards`` ranks
    (shard s owns nodes ``[s·n/S, (s+1)·n/S)``) the largest count of one
    shard's nodes in a list."""
    if shards == 1:
        return max((r.size for r in lists), default=0)
    bounds = np.arange(1, shards) * (n // shards)
    w = 0
    for r in lists:
        if r.size:
            w = max(w, int(np.max(np.diff(np.searchsorted(
                r, np.concatenate([[0], bounds, [n]]))))))
    return w


def _pack_index_lists(lists, n: int, width: int, shards: int):
    """(T,) ascending index lists -> (T, shards·width) int32, -1 padded;
    shard s's ids in columns ``[s·width, (s+1)·width)``, so each rank's
    slice holds only its own nodes."""
    ridx = np.full((len(lists), shards * width), -1, np.int32)
    if shards == 1:
        for t, r in enumerate(lists):
            ridx[t, :r.size] = r
        return ridx
    bounds = np.arange(1, shards) * (n // shards)
    for t, r in enumerate(lists):
        cuts = np.searchsorted(r, np.concatenate([[0], bounds, [n]]))
        for s in range(shards):
            seg = r[cuts[s]:cuts[s + 1]]
            ridx[t, s * width:s * width + seg.size] = seg
    return ridx


def dense_table(win, T: int, K: int, n: int) -> np.ndarray:
    """The dense (T, K, n) routing table from a winner tuple: entry
    [t, r, dst] holds the flat slot id of dst's round-r receive at cycle
    t, -1 = no receive. At N=10^6 it is the router's largest allocation."""
    t_w, r_w, dst_w, slot_w = win
    src_slot = np.full((T, K, n), -1, np.int32)
    src_slot[t_w, r_w, dst_w] = slot_w
    return src_slot


def _packed_columns(lists, t_w, dst_w, n: int, width: int, shards: int):
    """Packed-table column of each winner: the position of ``dst_w[i]``
    inside its cycle's (shard-grouped) index list. ``t_w`` ascends, and
    every dst is in its cycle's list (winner rounds nest)."""
    cols = np.empty(t_w.size, np.int64)
    bounds = np.searchsorted(t_w, np.arange(len(lists) + 1))
    shard_size = n // shards
    for t, r in enumerate(lists):
        lo, hi = bounds[t], bounds[t + 1]
        if hi == lo:
            continue
        d = dst_w[lo:hi]
        pos = np.searchsorted(r, d)
        if shards == 1:
            cols[lo:hi] = pos
        else:
            s = d // shard_size
            cuts = np.searchsorted(r, np.arange(shards) * shard_size)
            cols[lo:hi] = s * width + (pos - cuts[s])
    return cols


def pack_compact_rounds(win, multi, T: int, K: int, n: int, width: int,
                        shards: int = 1):
    """The ``compact`` tables: ``src0`` (T, n) the round-1 slots (dense),
    ``ridx`` (T, S·M) the round-2 receivers' node ids, -1 padded and
    grouped by shard, and ``rslot`` (T, K-1, S·M) their rounds 2..K's
    slots, -1 = none."""
    t_w, r_w, dst_w, slot_w = win
    m0 = r_w == 0
    src0 = np.full((T, n), -1, np.int32)
    src0[t_w[m0], dst_w[m0]] = slot_w[m0]
    ridx = _pack_index_lists(multi, n, width, shards)
    rslot = np.full((T, K - 1, ridx.shape[1]), -1, np.int32)
    mk = ~m0
    cols = _packed_columns(multi, t_w[mk], dst_w[mk], n, width, shards)
    rslot[t_w[mk], r_w[mk] - 1, cols] = slot_w[mk]
    return src0, ridx, rslot


def pack_compact_all(win, recv, T: int, K: int, n: int, width: int,
                     shards: int = 1):
    """The ``compact_all`` tables: ``ridx`` (T, S·M) the round-1
    receivers' node ids, -1 padded and grouped by shard, and ``rslot``
    (T, K, S·M) their K rounds' slots, -1 = none."""
    t_w, r_w, dst_w, slot_w = win
    ridx = _pack_index_lists(recv, n, width, shards)
    rslot = np.full((T, K, ridx.shape[1]), -1, np.int32)
    cols = _packed_columns(recv, t_w, dst_w, n, width, shards)
    rslot[t_w, r_w, cols] = slot_w
    return ridx, rslot


# ---------------------------------------------------------------------------
# the node mesh
# ---------------------------------------------------------------------------


REMOTE = -2       # a routing-table entry whose payload arrives from a peer


class NodeShard:
    """This rank's block of the node axis, ``[lo, hi)`` of n nodes over the
    axis's W ranks, and the per-chunk plan of its payload exchange.

    A slot id ``row·n + sender`` names a payload in the (D, n, P) buffer,
    whose rows each rank holds for its own senders only. A receiver's
    winning slot may lie on another rank: each cycle, before the receives,
    every rank sends each other rank the payload rows (with their counter,
    scale and zero-point) that the other's receivers read this cycle,
    and nothing else: one all-to-all whose split sizes every rank knows,
    since every rank routes the whole population. Within a (sender rank,
    receiver rank) block the rows travel in ascending slot id.

    :meth:`plan` lists, from a chunk's winner tuple, the local buffer rows
    this rank sends and the counts it sends and receives a cycle;
    :meth:`localize` rewrites one of this rank's routing tables: its own
    slots become local flat buffer rows ``row·(n/W) + sender - lo``, the
    others :data:`REMOTE`, with the table position and the received row
    that fills each of them."""

    def __init__(self, axis, n: int, delay_max: int):
        self.axis = axis
        self.shards, self.index = axis.size, axis.index
        self.n, self.D = n, delay_max
        self.nl = n // self.shards
        self.lo, self.hi = self.index * self.nl, (self.index + 1) * self.nl

    def plan(self, win, T: int) -> dict:
        """From a chunk's winners: the local buffer rows this rank sends
        (``send_idx``, by cycle, then destination rank, then slot id), the
        (T, W) counts it sends and receives, and the sorted keys (cycle,
        sender rank, slot) of the rows it receives, with each cycle's
        first key (``start``)."""
        t_w, _, dst_w, slot_w = win
        W, n, nl, me = self.shards, self.n, self.nl, self.index
        to = dst_w // nl
        owner = (slot_w % n) // nl
        remote = to != owner
        out = remote & (owner == me)
        t_o, to_o, slot_o = t_w[out], to[out], slot_w[out]
        order = np.lexsort((slot_o, to_o, t_o))
        slot_o = slot_o[order].astype(np.int64)
        send_idx = (slot_o // n) * nl + slot_o % n - self.lo
        send = np.bincount(t_o.astype(np.int64) * W + to_o,
                           minlength=T * W).reshape(T, W)
        inn = remote & (to == me)
        t_i, own_i = t_w[inn].astype(np.int64), owner[inn].astype(np.int64)
        keys = np.sort(t_i * (W * self.D * n) + own_i * (self.D * n)
                       + slot_w[inn])
        recv = np.bincount(t_i * W + own_i, minlength=T * W).reshape(T, W)
        start = np.concatenate([[0], np.cumsum(recv.sum(axis=1))])
        return dict(send_idx=send_idx, send=send, recv=recv, keys=keys,
                    start=start)

    def localize(self, tab, plan):
        """``tab`` (T, ...) of global slot ids (-1 none) -> the same table
        with this rank's rows and :data:`REMOTE` entries, and the remote
        entries' positions (flat within a cycle's table) and received
        rows, as (T,)-long lists of int64 arrays."""
        W, n, nl, me, D = self.shards, self.n, self.nl, self.index, self.D
        T = tab.shape[0]
        flat = tab.reshape(T, -1).astype(np.int64)
        out = np.full(flat.shape, -1, np.int64)
        has = flat >= 0
        owner = np.where(has, (flat % n) // nl, -1)
        own = has & (owner == me)
        v = flat[own]
        out[own] = (v // n) * nl + v % n - self.lo
        rem = has & ~own
        out[rem] = REMOTE
        tt, pos = np.nonzero(rem)
        key = tt * (W * D * n) + owner[tt, pos] * (D * n) + flat[tt, pos]
        row = np.searchsorted(plan["keys"], key) - plan["start"][tt]
        cuts = np.searchsorted(tt, np.arange(1, T))
        return (out.astype(np.int32).reshape(tab.shape),
                np.split(pos, cuts), np.split(row, cuts))

    def own_winners(self, win):
        """The winners that this rank's nodes receive, at their row ids."""
        t_w, r_w, dst_w, slot_w = win
        m = (dst_w >= self.lo) & (dst_w < self.hi)
        return t_w[m], r_w[m], dst_w[m] - self.lo, slot_w[m]

    def chunk_tables(self, mode: str, tables, win, T: int):
        """This rank's tables of a chunk: the dense table of its own nodes
        (:meth:`own_winners`), or its columns of the shard-grouped packed
        tables, their node ids made row ids and every slot table
        localized. Returns ``(tables, counts, plan, remotes)``: ``counts``
        the real lengths of its packed lists (the driver's ``counts``),
        ``remotes`` each slot table's (positions, rows)."""
        plan = self.plan(win, T)
        real = lambda a: (a >= 0).sum(axis=1)  # noqa: E731
        if mode == "dense":
            src, pos, row = self.localize(tables[0], plan)
            return (src,), None, plan, [(pos, row)]
        if mode == "compact":
            src0, ridx, rslot = tables
            w = ridx.shape[1] // self.shards
            ridx = self.rows(self.columns(ridx, w))
            src0, p0, r0 = self.localize(src0[:, self.lo:self.hi], plan)
            rslot, p1, r1 = self.localize(self.columns(rslot, w), plan)
            return ((src0, ridx, rslot), (real(ridx),), plan,
                    [(p0, r0), (p1, r1)])
        ridx, rslot, sidx = tables
        w, ws = ridx.shape[1] // self.shards, sidx.shape[1] // self.shards
        ridx = self.rows(self.columns(ridx, w))
        sidx = self.rows(self.columns(sidx, ws))
        rslot, pos, row = self.localize(self.columns(rslot, w), plan)
        return ((ridx, rslot, sidx), (real(ridx), real(sidx)), plan,
                [(pos, row)])

    def rows(self, ids):
        """Global node ids (-1 padding kept) -> this rank's row ids."""
        return np.where(ids >= 0, ids - self.lo, -1).astype(np.int32)

    def columns(self, packed, width: int):
        """This rank's columns of a shard-grouped packed table."""
        lo = self.index * width
        return packed[..., lo:lo + width]


# ---------------------------------------------------------------------------
# data plane
# ---------------------------------------------------------------------------


@dataclass
class Carry:
    """The data-plane state between cycles, updated in place: the fields
    of the reference chunk function's carry."""
    last_w: torch.Tensor       # (N, d) f32
    last_t: torch.Tensor       # (N,) i32
    fresh_w: torch.Tensor      # (N, d) f32 freshest model
    fresh_t: torch.Tensor      # (N,) i32
    cache: ModelCache
    buf_w: torch.Tensor        # (D, N, P) in-flight payloads (codec dtype)
    buf_t: torch.Tensor        # (D, N) i32
    buf_scale: torch.Tensor    # (D, N) f16 scale  ((0, 0) when the codec
    buf_zp: torch.Tensor       # (D, N) f16 zp      does not carry the lane)
    ef: torch.Tensor           # (N, d) f32 sender EF residual ((0, 0) if none)
    clock: int


def init_carry(n: int, d: int, cache_size: int, delay_max: int, device,
               codec: WireCodec) -> Carry:
    """The all-zero carry at cycle 0, its buffer in ``codec``'s lanes."""
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=device)
    lane = lambda has, *s: s if has else (0, 0)
    return Carry(z(n, d), z(n, dt=torch.int32), z(n, d),
                 z(n, dt=torch.int32),
                 cache_mod.init_cache(n, cache_size, d, device),
                 z(delay_max, n, codec.payload_cols(d),
                   dt=codec.payload_dtype),
                 z(delay_max, n, dt=torch.int32),
                 z(*lane(codec.has_scale, delay_max, n), dt=torch.float16),
                 z(*lane(codec.has_zp, delay_max, n), dt=torch.float16),
                 z(*lane(codec.ef, n, d)), 0)


def _vector_apply(last_w, last_t, fresh_w, fresh_t, cache: ModelCache,
                  msg_w, msg_t, valid, X, y, *, variant: str, update,
                  defense: str = "none"):
    """The reference's vector apply (Algorithm 1 ON RECEIVE, K rounds) in
    plain PyTorch, for Adaline and logistic regression (the engine applies
    Pegasos with the receive kernel): the screen of each round against the
    receiver's current chain model (``faults.apply_defense``), then the K
    CREATEMODEL calls batched over (K, N, d) (the merge partner of round k
    is the round-(k-1) message, known up front), the K cache writes as one
    one-hot combine, and the freshest model tracked. ``update`` is the
    learner's step; the engine passes ``make_update(..., fused=True)``,
    the order XLA runs it in under ``jax.jit``, so the result equals the
    jitted reference's bit for bit where that order is known
    (``learners``' module note). msg_w: (K, N, d) decoded f32; msg_t,
    valid: (K, N). Returns new tensors ``(last_w, last_t, fresh_w,
    fresh_t, cache, gated, clipped)``, the last two (N,) int32."""
    msg_w = msg_w.to(torch.float32)
    K, n, _ = msg_w.shape
    C = cache.w.shape[1]
    dev = msg_w.device
    rows = torch.arange(n, device=dev)
    iota_c = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
    prev_w, prev_t = last_w, last_t
    off = torch.zeros(n, dtype=torch.int32, device=dev)
    sel = torch.full((n, C), -1, dtype=torch.int32, device=dev)
    last_k = torch.zeros(n, dtype=torch.int64, device=dev)
    gated = torch.zeros(n, dtype=torch.int32, device=dev)
    clipped = torch.zeros_like(gated)
    m1w, m1t, m2w, m2t = [], [], [], []
    for k in range(K):
        mw, vm, g, cl = faults.apply_defense(defense, msg_w[k], valid[k],
                                             prev_w)
        gated += g.to(torch.int32)
        clipped += cl.to(torch.int32)
        m1w.append(mw)
        m1t.append(msg_t[k])
        m2w.append(prev_w)
        m2t.append(prev_t)
        # round k writes slot (ptr + #valid rounds before k) % C; later
        # rounds win on collision (only when K > C)
        slot_k = (cache.ptr + off) % C
        sel = torch.where((iota_c == slot_k[:, None]) & vm[:, None], k, sel)
        off = off + vm.to(torch.int32)
        last_k = torch.where(vm, k, last_k)
        prev_w = torch.where(vm[:, None], mw, prev_w)
        prev_t = torch.where(vm, msg_t[k], prev_t)
    new = create_model(variant, update,
                       LinearModel(torch.stack(m1w), torch.stack(m1t)),
                       LinearModel(torch.stack(m2w), torch.stack(m2t)),
                       X.expand(K, *X.shape), y.expand(K, *y.shape))
    hit = sel >= 0
    selc = torch.clamp_min(sel, 0).long()
    cw = torch.where(hit[:, :, None], new.w[selc, rows[:, None]], cache.w)
    ct = torch.where(hit, new.t[selc, rows[:, None]], cache.t)
    new_cache = ModelCache(cw, ct, cache.ptr + off,
                           torch.clamp_max(cache.count + off, C))
    got_any = off > 0
    fw = torch.where(got_any[:, None], new.w[last_k, rows], fresh_w)
    ft = torch.where(got_any, new.t[last_k, rows], fresh_t)
    return prev_w, prev_t, fw, ft, new_cache, gated, clipped


class _Plane:
    """What every cycle of a chunk reads: the carry's flat buffer views,
    the codec, the fault, the learner's step and the receive's options."""

    def __init__(self, carry: Carry, *, variant, lam, learner, eta, wire,
                 fault_model, byz, defense, shard: Optional[NodeShard] = None):
        self.codec = get_codec(wire)
        self.fault = faults.get_fault(fault_model)
        D, n, P = carry.buf_w.shape
        # the population's size and this block's first node: a node mesh's
        # rank holds rows [lo, lo + n) of it, and draws the SR noise and
        # the faults at those global rows
        self.n_total = n if shard is None else shard.n
        self.lo = 0 if shard is None else shard.lo
        self.rows_all = (None if shard is None else torch.arange(
            shard.lo, shard.hi, device=carry.buf_w.device))
        self.flat_w = carry.buf_w.view(D * n, P)
        self.flat_t = carry.buf_t.view(D * n)
        self.flat_sc = carry.buf_scale.view(-1)
        self.flat_zp = carry.buf_zp.view(-1)
        self.variant, self.lam, self.defense, self.byz = (variant, lam,
                                                          defense, byz)
        # Pegasos runs the receive kernel; the other learners the vector
        # apply with the step in the jitted reference's order
        self.update = (None if learner == "pegasos" else
                       make_update(learner, lam=lam, eta=eta, fused=True))

    def receive(self, carry: Carry, src, Xc, yc, ridx=None, real: int = 0,
                remote=None):
        """Apply the rounds of the (K', W) slot table ``src`` (-1 = no
        receive): to all N nodes, or with ``ridx`` (W,) to those node ids
        (-1 = padding, gathered as node 0 with no valid round), whose
        first ``real`` rows are scattered back. Under a node mesh,
        ``remote`` = ``(pos, row, got)`` fills the :data:`REMOTE` entries
        (flat positions ``pos`` of ``src``) with the rows ``row`` of the
        payload lanes ``got`` that arrived from the other ranks. Returns
        the (N or W,) gated and clipped counts."""
        codec, c = self.codec, carry.cache
        idx = torch.clamp_min(src, 0).long()
        valid = src != -1
        if ridx is None:
            state = [carry.last_w, carry.last_t, c.w, c.t, c.ptr, c.count]
            fresh = [carry.fresh_w, carry.fresh_t]
            Xs, ys = Xc, yc
        else:
            gi = torch.clamp_min(ridx, 0).long()
            valid = valid & (ridx >= 0)[None, :]
            state = [a[gi] for a in (carry.last_w, carry.last_t, c.w, c.t,
                                     c.ptr, c.count)]
            fresh = [carry.fresh_w[gi], carry.fresh_t[gi]]
            Xs, ys = Xc[gi], yc[gi]
        msgs = [self.flat_w[idx], self.flat_t[idx],
                self.flat_sc[idx] if codec.has_scale else None,
                self.flat_zp[idx] if codec.has_zp else None]
        if remote is not None and remote[0].numel():
            pos, row, got = remote
            for m, g in zip(msgs, got):
                if m is not None:
                    m.view((-1,) + tuple(m.shape[2:]))[pos] = g[row]
        mw, mt, msc, mzp = msgs
        if self.update is None:
            out = gossip_cycle.fused_receive_apply(
                *state, mw, mt, valid.to(torch.int32), Xs, ys,
                msg_scale=msc, msg_zp=mzp, wire=codec.name,
                variant=self.variant, lam=self.lam, defense=self.defense)
            gated, clipped = out[6], out[7]
            # the freshest model: slot ptr - 1 of the updated ring
            C = c.w.shape[1]
            slot = ((state[4] - 1) % C).long()
            at = torch.arange(slot.shape[0], device=slot.device)
            fresh = [state[2][at, slot], state[3][at, slot]]
        else:
            msg_w = codec.decode(mw, msc, mzp, c.w.shape[2])
            lw, lt, fw, ft, c2, gated, clipped = _vector_apply(
                state[0], state[1], fresh[0], fresh[1],
                ModelCache(*state[2:]), msg_w, mt, valid, Xs,
                ys, variant=self.variant, update=self.update,
                defense=self.defense)
            state = [lw, lt, *c2]
            fresh = [fw, ft]
        if ridx is None:
            if self.update is not None:
                carry.last_w, carry.last_t = state[0], state[1]
                carry.cache = ModelCache(*state[2:])
            carry.fresh_w, carry.fresh_t = fresh
        else:
            # only the real rows go back; the padding is never written
            r = gi[:real]
            for dst, val in zip((carry.last_w, carry.last_t, c.w, c.t,
                                 c.ptr, c.count, carry.fresh_w,
                                 carry.fresh_t), state + fresh):
                dst[r] = val[:real]
        return gated, clipped

    def send(self, carry: Carry, t: int, kr, fk, send_mask=None, sidx=None):
        """Refresh this cycle's buffer row with each node's freshest model
        (encoded for a quantized codec, corrupted on the Byzantine rows),
        or with ``sidx`` (the cycle's sender ids) only the senders' slots,
        their SR noise, fault draws and EF rows taken at their positions
        in the dense draw (``rows=``; a node mesh's rank draws at its
        block's global rows)."""
        codec, fault, c = self.codec, self.fault, carry.cache
        row = carry.clock % carry.buf_w.shape[0]
        if sidx is None:
            gi, rows, byz = None, self.rows_all, self.byz
            send_w, send_t = carry.fresh_w, carry.fresh_t
            ef = carry.ef
        else:
            gi = sidx.long()
            rows = gi + self.lo
            byz = None if self.byz is None else self.byz[gi]
            send_w, send_t = carry.fresh_w[gi], carry.fresh_t[gi]
            ef = carry.ef[gi] if codec.ef else carry.ef
        if fault is not None and fault.kind == "model":
            old_w = old_t = None
            if fault.name == "stale_replay":
                sub = c if gi is None else ModelCache(c.w[gi], c.t[gi],
                                                      c.ptr[gi], c.count[gi])
                old_w, old_t = cache_mod.cache_oldest(sub)
            send_w, send_t = faults.corrupt_model(
                fault, byz, fk[t], send_w, send_t, old_w, old_t, rows=rows,
                n_total=self.n_total)
        sc = zp = None
        if codec.quantized:
            out = gossip_cycle.quantize_send(
                send_w, codec.name, key=kr[t] if codec.stochastic else None,
                ef=ef if codec.ef else None, rows=rows)
            payload, sc = out[0], out[1]
            if codec.has_zp:
                zp = out[2]
            if codec.ef:
                if gi is None:
                    carry.ef = torch.where(send_mask[t][:, None], out[2],
                                           carry.ef)
                else:
                    carry.ef[gi] = out[2]
        else:
            payload = send_w.to(codec.payload_dtype)
        if fault is not None and fault.kind == "wire":
            payload = faults.bitflip_payload(
                byz, fk[t], payload.to(codec.payload_dtype), rows=rows,
                n_total=self.n_total)
        at = slice(None) if gi is None else gi
        carry.buf_w[row, at] = payload
        carry.buf_t[row, at] = send_t
        if sc is not None:
            carry.buf_scale[row, at] = sc
        if zp is not None:
            carry.buf_zp[row, at] = zp


class ChunkExchange:
    """A chunk's payload exchange on the device (:class:`NodeShard`): the
    local buffer rows this rank sends each cycle, the counts, and for
    each slot table the positions and received rows of its
    :data:`REMOTE` entries."""

    def __init__(self, shard: NodeShard, plan: dict, remotes, device):
        self.axis = shard.axis
        self.send, self.recv = plan["send"], plan["recv"]
        self.cuts = np.concatenate([[0], np.cumsum(self.send.sum(axis=1))])
        self.send_idx = torch.as_tensor(plan["send_idx"], device=device)
        # per table, its (T,) position and row arrays, each concatenated
        # over the cycles with the host's offsets
        self.tables = []
        for pos, row in remotes:
            off = np.concatenate([[0], np.cumsum([p.size for p in pos])])
            self.tables.append((
                torch.as_tensor(np.concatenate(pos), device=device),
                torch.as_tensor(np.concatenate(row), device=device), off))

    def received(self, plane: "_Plane", t: int):
        """Cycle t's exchange: this rank's rows out, the other ranks' rows
        in, as the payload lanes ``[w, t, scale or None, zp or None]``."""
        idx = self.send_idx[self.cuts[t]:self.cuts[t + 1]]
        codec = plane.codec
        lanes = [plane.flat_w, plane.flat_t,
                 plane.flat_sc if codec.has_scale else None,
                 plane.flat_zp if codec.has_zp else None]
        got = iter(compat.exchange_rows(
            [a[idx] for a in lanes if a is not None], self.send[t],
            self.recv[t], self.axis))
        return [None if a is None else next(got) for a in lanes]

    def remote(self, k: int, t: int, got):
        pos, row, off = self.tables[k]
        return pos[off[t]:off[t + 1]], row[off[t]:off[t + 1]], got


def run_chunk(carry: Carry, mode: str, tables, X, y, *, variant: str,
              lam: float, learner: str = "pegasos", eta: float = 0.01,
              wire=None, keys=None, send_mask=None, counts=None,
              fault_model=None, byz=None, defense: str = "none",
              per_cycle: bool = False,
              exchange: Optional[ChunkExchange] = None,
              shard: Optional[NodeShard] = None):
    """Run the chunk's cycles under packing ``mode``, in place — the
    reference's ``dense_body``, ``compact_body`` or ``compact_all_body``
    under ``lax.scan``. ``tables`` are the packing's device tables:
    ``(src,)`` the (T, K, N) slots for ``dense``; ``(src0, ridx, rslot)``
    for ``compact``; ``(ridx, rslot, sidx)`` for ``compact_all`` (the
    ``pack_*`` functions, and the senders' ids). ``counts`` gives each
    cycle's real (unpadded) lengths on the host: ``(multi_sizes,)`` for
    ``compact``, ``(recv_sizes, send_sizes)`` for ``compact_all``.
    ``X``/``y`` are (N, d)/(N,) or (N, k, d)/(N, k) for k records per node
    (cycle c uses record ``c % k``). ``wire`` names the buffer's codec;
    ``int8_sr`` needs ``keys``, the chunk's (T, 2) cycle keys (its noise
    key is ``split(key, 4)[0]``), and the ``_ef`` codecs under ``dense``
    and ``compact`` ``send_mask``, the (T, N) ``arrival >= 0`` table: the
    EF residual refreshes only where a node sends.

    The receive is kernel #1 for Pegasos (its plain version on CPU
    tensors): under ``compact`` a K = 1 launch over all N, then K - 1
    rounds over the round-2 receivers; under ``compact_all`` K rounds over
    the round-1 receivers. The other learners run ``_vector_apply``.
    ``fault_model`` with ``byz`` (the (N,) bool Byzantine mask) corrupts
    the Byzantine rows' transmitted model before the encode (model-kind)
    or their payload after it (``bitflip``), with the fault keys
    ``fold_in(keys, FAULT_FOLD)``; ``defense`` is the receive's screen.
    Returns ``(carry, screen)``: ``screen`` is the (2,) int64 device
    tensor of the chunk's gated and clipped totals, or with ``per_cycle``
    (armed telemetry) the (T, 2) tensor of each cycle's.

    Under a node mesh the carry, ``X``/``y``, ``byz`` and the tables are
    this rank's block (``shard``), and ``exchange`` brings each cycle's
    payloads from the other ranks before the receives."""
    plane = _Plane(carry, variant=variant, lam=lam, learner=learner,
                   eta=eta, wire=wire, fault_model=fault_model, byz=byz,
                   defense=defense, shard=shard)
    kr = recv_keys(keys) if plane.codec.stochastic else None
    fk = faults.fault_key(keys) if plane.fault is not None else None
    T = tables[0].shape[0]
    screen = torch.zeros((T, 2) if per_cycle else 2, dtype=torch.int64,
                         device=carry.buf_w.device)
    for t in range(T):
        if X.ndim == 3:
            rec = carry.clock % X.shape[1]
            Xc, yc = X[:, rec, :].contiguous(), y[:, rec].contiguous()
        else:
            Xc, yc = X, y
        got = exchange.received(plane, t) if exchange is not None else None

        def remote(k):
            return None if got is None else exchange.remote(k, t, got)
        if mode == "dense":
            rounds = [plane.receive(carry, tables[0][t], Xc, yc,
                                    remote=remote(0))]
        elif mode == "compact":
            src0, ridx, rslot = tables
            rounds = [plane.receive(carry, src0[t][None], Xc, yc,
                                    remote=remote(0)),
                      plane.receive(carry, rslot[t], Xc, yc, ridx[t],
                                    int(counts[0][t]), remote=remote(1))]
        else:
            ridx, rslot, _ = tables
            rounds = [plane.receive(carry, rslot[t], Xc, yc, ridx[t],
                                    int(counts[0][t]), remote=remote(0))]
        if defense != "none":
            got = torch.stack([sum(g.sum() for g, _ in rounds),
                               sum(c.sum() for _, c in rounds)])
            if per_cycle:
                screen[t] = got
            else:
                screen += got
        if mode == "compact_all":
            plane.send(carry, t, kr, fk,
                       sidx=tables[2][t, :int(counts[1][t])])
        else:
            plane.send(carry, t, kr, fk, send_mask=send_mask)
        carry.clock += 1
    return carry, screen


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


# the packings, and the reference's cost model's constants (calibrated on
# its 2-core CPU container; kept so that the port picks what the reference
# picks on the same tables)
PACKINGS = ("dense", "compact", "compact_all")
_MIN_WIDTH = 8


def choose_packing(k_rounds: int, n: int, multi_sizes, recv_sizes, wm: int,
                   w1: int, senders_width, shards: int = 1):
    """The reference's per-chunk packing choice: per-cycle work estimates
    in node rows, dense = K N + N, compact = N + (K + 1) S W_multi + N,
    compact_all = (K + 4) S W_recv + 5 S W_send, over the sticky per-shard
    widths of S node shards; a packing whose subset exceeds N/2 somewhere
    in the chunk is out. ``senders_width()`` gives W_send, asked only when
    compact_all is in the running. Returns ``(mode, ws)``, ws the senders'
    width if asked."""
    cand = {"dense": k_rounds * n + n}
    ws = None
    if k_rounds > 1 and int(multi_sizes.max(initial=0)) <= n // 2:
        cand["compact"] = n + (k_rounds + 1) * shards * wm + n
    if int(recv_sizes.max(initial=0)) <= n // 2:
        ws = senders_width()
        cand["compact_all"] = (k_rounds + 4) * shards * w1 + 5 * shards * ws
    return min(cand, key=cand.get), ws


# the distinct signatures the process's chunks and draws ran
# (retrace_counts), the chunks' by configuration label
_CHUNK_LABELS: Dict[tuple, str] = {}
_CHUNK_SIGS: Dict[str, set] = {}
_DRAW_SIGS: set = set()


def retrace_counts() -> Dict[str, int]:
    """The counterpart of the reference's compile-cache counts, under its
    names. The port runs eagerly and has no trace cache; it counts the
    distinct signatures that this process's chunks executed (the packing
    mode, T, the packed widths, the carry's and the codec's shapes) per
    configuration label, the reference's ``index:variant/learner/mode/
    wire`` with its fault, defense and telemetry suffixes, and the
    distinct draw signatures (T, N and the draw's settings). A run whose
    packed widths never go sticky shows up here as in the reference."""
    counts = {"sharded_engine._draw_chunk": len(_DRAW_SIGS)}
    for label, sigs in _CHUNK_SIGS.items():
        counts[f"sharded_engine.chunk_fn[{label}]"] = len(sigs)
    return counts


def _chunk_signatures(cfg: GossipLinearConfig, D: int, mode: str,
                      armed: bool, shards: int) -> set:
    """The signature set of one chunk configuration, made on first use."""
    key = (cfg.variant, cfg.learner, cfg.lam, cfg.eta, D, mode,
           cfg.wire_dtype, cfg.fault_model, cfg.defense, armed, shards)
    if key not in _CHUNK_LABELS:
        label = (f"{len(_CHUNK_SIGS)}:{cfg.variant}/{cfg.learner}/{mode}/"
                 f"{cfg.wire_dtype or 'f32'}"
                 + (f"/fault:{cfg.fault_model}" if cfg.fault_model else "")
                 + (f"/def:{cfg.defense}" if cfg.defense != "none" else "")
                 + ("/telem" if armed else ""))
        _CHUNK_LABELS[key] = label
        _CHUNK_SIGS[label] = set()
    return _CHUNK_SIGS[_CHUNK_LABELS[key]]


def _node_shard(mesh, node_axis: Optional[str], n: int,
                delay_max: int) -> Optional[NodeShard]:
    """This rank's :class:`NodeShard` of ``mesh``'s node axis (default:
    its first), or None on an axis of size 1 (the one-device path)."""
    if mesh is None:
        return None
    axis = node_axis or mesh.mesh_dim_names[0]
    size = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))[axis]
    if size == 1:
        return None
    if n % size != 0:
        raise ValueError(
            f"sharded engine needs N divisible by the '{axis}' mesh "
            f"axis ({n} % {size} != 0)")
    return NodeShard(compat.mesh_axis(mesh, (axis,)), n, delay_max)


def _gathered_rms(squares, shard: NodeShard) -> list:
    """The EF residual's RMS at each eval point from every rank's
    ``ef_squares``: one all-gather of the points' squares, and each
    point's mean over the N nodes in node order, the one-device value
    bit for bit."""
    if not squares or squares[0] is None:
        return squares
    local = torch.stack(squares, dim=1)                 # (N/W, points)
    (every,) = compat.gather_rows([local], [shard.nl] * shard.shards,
                                  shard.axis)
    return [torch.sqrt(torch.mean(every[:, j].contiguous()))
            for j in range(every.shape[1])]


def _final_state(carry: Carry, shard: Optional[NodeShard]) -> dict:
    """Every node's final lanes on the host (the EF residual where the
    codec keeps one), gathered from every rank under a node mesh."""
    c = carry.cache
    lanes = dict(last_w=carry.last_w, last_t=carry.last_t,
                 fresh_w=carry.fresh_w, fresh_t=carry.fresh_t, cache_w=c.w,
                 cache_t=c.t, ptr=c.ptr, count=c.count)
    if carry.ef.numel():
        lanes["ef"] = carry.ef
    if shard is not None:
        vals = compat.gather_rows(list(lanes.values()),
                                  [shard.nl] * shard.shards, shard.axis)
        lanes = dict(zip(lanes, vals))
    return {k: v.cpu() for k, v in lanes.items()}


class _MeshEval:
    """The eval under a node mesh: the eval nodes' cache rows gathered
    from their ranks to every rank, in ``eval_idx``'s order, and
    evaluated as one device evaluates them, so the curves are exact."""

    def __init__(self, shard: NodeShard, eval_idx: np.ndarray, device):
        self.shard = shard
        owner = eval_idx // shard.nl
        by_rank = np.argsort(owner, kind="stable")
        self.counts = np.bincount(owner, minlength=shard.shards)
        mine = eval_idx[owner == shard.index] - shard.lo
        self.mine = torch.as_tensor(mine, device=device)
        self.order = torch.as_tensor(np.argsort(by_rank), device=device)
        self.at = torch.arange(eval_idx.size, device=device)

    def __call__(self, cache: ModelCache, X_test, y_test):
        rows = [a[self.mine] for a in cache]
        got = compat.gather_rows(rows, self.counts, self.shard.axis)
        sub = ModelCache(*(g[self.order] for g in got))
        return _eval(sub, self.at, X_test, y_test)


def run_sharded_simulation(cfg: GossipLinearConfig, X, y, X_test, y_test, *,
                           cycles: int = 200, eval_every: int = 10,
                           seed: int = 0, eval_nodes: int = 100,
                           sampler: str = "uniform", k_rounds: int = 4,
                           device=None, use_kernel: Optional[bool] = None,
                           compact_rounds: Optional[bool] = None,
                           compact_mode: Optional[str] = None, mesh=None,
                           node_axis: Optional[str] = None,
                           use_send_kernel: Optional[bool] = None,
                           serve_hook=None, telemetry=None,
                           final_state: bool = False) -> SimResult:
    """Run the protocol with the mega-population engine, on one device or
    over a node mesh.

    The receive step of Pegasos is the fused kernel on CUDA and its plain
    version on the CPU; ``use_kernel=True`` asserts the kernel (raises on
    the CPU) and ``use_kernel=False`` asserts the plain version (raises on
    CUDA, where the receive step is always the kernel). ``use_send_kernel``
    does the same for the send kernel of the quantized wire codecs, and is
    refused for the float codecs, which send a plain cast. Adaline and
    logistic regression run the vector apply (``_vector_apply``) on both
    devices, as the reference does on every backend.

    ``compact_rounds`` allows the compact packings, chosen per chunk by
    the reference's cost model from the router's receiver counts (the
    module note); by the reference's rule it defaults to on wherever the
    receive is not the kernel the reference runs dense: on the CPU, and
    on CUDA for the learners other than Pegasos. On CUDA with Pegasos it
    defaults to off, so the main path stays dense. ``compact_mode``
    ("dense", "compact" or "compact_all") forces one packing on every
    chunk. ``SimResult.compaction`` reports the packings taken, the round-1
    and round-2 receivers' occupancy and the packed widths, as the
    reference does.

    ``mesh`` (a ``DeviceMesh``, ``launch.mesh.make_mesh``) splits the nodes
    over its ``node_axis`` (default: its first axis) of W ranks; N must be
    divisible by W, and an axis of size 1 runs the one-device path. Every
    rank calls this function with the same global data and gets the whole
    :class:`SimResult`. Every rank draws and routes the whole population
    (the draws do not depend on the payloads, so the tables are equal on
    every rank) and keeps the nodes ``[s·N/W, (s+1)·N/W)`` of its index s:
    their models, cache, buffer rows, scale, zero-point and EF lanes. It
    runs the receive (kernel #1) and the send (kernel #2 with the block's
    global rows, so ``int8_sr`` draws the one-device noise; #3/#4) on its
    block, under every packing (the reference's per-shard packed tables);
    each cycle one all-to-all brings the payloads its receivers read from
    the other ranks (:class:`NodeShard`). The eval gathers the eval nodes'
    rows, and the screen's counts and the EF norm are reduced over the
    ranks, so the result is the one-device run's bit for bit, but where a
    screen's sum order depends on the row count (5 <= d <= 8,
    ``faults.screen_split``): a rank sums over its N/W rows, as the
    reference's ``shard_map`` body does.

    ``serve_hook(cycle, snapshot)`` is called at every eval point with
    ``serving.snapshot_from_carry(carry)``, a copy of the live cache, before
    the next chunk updates the carry in place. Under a node mesh each
    rank's hook gets its shard's snapshot (``snapshot.shard`` places its
    rows; ``serving.gather_snapshot`` makes the whole one where a hook asks
    for it), and ``GossipServer`` serves on the shards.

    ``telemetry`` (a :class:`repro_torch.core.telemetry.Telemetry`), when
    armed, gets the reference's per-cycle streams, counted on the host from
    the router's tables, but for the screen's counts, kept per cycle on the
    device and read with the curves after the last chunk, and the EF
    residual's RMS, queued at each eval point before the next chunk runs
    and read there too; and host spans that never nest, one per phase of
    the driver: ``setup``, ``draw_enqueue``, ``draw_readback``,
    ``route_chunk`` (the numpy router alone), ``pack_tables`` (the packing
    choice and the compact tables, where compacting is on),
    ``dense_table``, ``table_upload``, ``chunk_dispatch``, ``eval``,
    ``snapshot`` and ``collect_results``. An armed run adds no
    synchronisation and no kernel launch of #1 to #5, and is bit for bit
    the unarmed run. Under a node mesh every rank gets the whole streams:
    the host streams come from the router's tables, which every rank
    holds whole; the screen's per-cycle counts are summed over the ranks
    with the unarmed totals, once, after the last chunk; and each eval
    point's per-node squares of the EF residual stay on the rank's device
    until then, when one all-gather brings every node's and the RMS is
    the one-device mean over the same N values. So an armed run adds no
    collective a chunk. The spans are each rank's own, tagged with its
    rank (``Telemetry.rank``); the per-cycle exchange runs inside
    ``chunk_dispatch`` and has no span of its own (spans never nest).

    ``final_state=True`` sets ``SimResult.final_state``: every node's
    final lanes on the host (gathered from every rank under a mesh)."""
    dev = resolve_device(device)
    codec = get_codec(cfg.wire_dtype)
    if use_send_kernel and not codec.quantized:
        raise ValueError("use_send_kernel needs a quantized (int8 or "
                         "sub-4-bit) wire dtype: float wire dtypes send a "
                         "plain cast")
    for opt, val in (("use_kernel", use_kernel),
                     ("use_send_kernel", use_send_kernel)):
        if val is not None and val != (dev.type == "cuda"):
            raise ValueError(
                f"{opt}={val} on {dev}: each step is its CUDA kernel on "
                "CUDA tensors and its plain version on CPU tensors")
    if compact_rounds is None:
        compact_rounds = dev.type != "cuda" or cfg.learner != "pegasos"
    if compact_mode is not None:
        if compact_mode not in PACKINGS:
            raise ValueError(f"unknown compact_mode {compact_mode!r}")
        if compact_mode == "compact" and k_rounds == 1:
            raise ValueError("compact_mode='compact' needs k_rounds > 1 "
                             "(there are no rounds >= 2 to compact)")
        compact_rounds = compact_mode != "dense"
    check_slice(cfg)
    n, d = X.shape[0], X.shape[-1]
    D = max(cfg.delay_max_cycles, 1)
    shard = _node_shard(mesh, node_axis, n, D)
    shards = 1 if shard is None else shard.shards
    tel = telemetry
    armed = tel is not None
    if armed and shard is not None:
        tel.rank = shard.axis.ranks[shard.index]

    with maybe_span(tel, "setup", track="host"):
        online_mat, eval_idx, X, y, X_test, y_test = sim_setup(
            cfg, X, y, X_test, y_test, cycles=cycles, seed=seed,
            eval_nodes=eval_nodes, device=dev)
        byz = byzantine_tensor(cfg, seed, n, dev)
        byz_np = None if byz is None else byz.cpu().numpy()
        evaluate = functools.partial(_eval, eval_idx=eval_idx)
        if shard is not None:
            block = slice(shard.lo, shard.hi)
            X, y = X[block].contiguous(), y[block].contiguous()
            byz = None if byz is None else byz[block].contiguous()
            evaluate = _MeshEval(shard, eval_idx.cpu().numpy(), dev)
        carry = init_carry(n // shards, d, cfg.cache_size, D, dev, codec)
        res = SimResult([], [], [], [], 0, cfg)
        res.buf_payload_bytes = payload_buffer_bytes(D, n, d, cfg.wire_dtype)
        pts = eval_points(cycles, eval_every)
        keys = key_schedule(seed, cycles, dev) if pts else None
    if not pts:
        return res

    router = _HostRouter(D)
    bounds = list(zip([0] + pts[:-1], pts))
    # compact widths, sticky across chunks (monotone powers of two), as
    # the reference keeps them for its jit cache: the subset applies run
    # over these padded widths, which a screen's sum order depends on at
    # 5 <= d <= 8
    widths = {"compact": _MIN_WIDTH, "compact_all": _MIN_WIDTH,
              "send": _MIN_WIDTH}
    mode_counts = dict.fromkeys(PACKINGS, 0)
    occ_recv, occ_multi = [], []

    def bucket(kind: str, need: int) -> int:
        w = widths[kind]
        while w < need:
            w *= 2
        return w

    def draw(i):
        """Chunk i's tables on the host, and (for the EF codecs) its send
        mask ``arrival >= 0`` kept on the device: the reference's
        ``send_ok``, without uploading it again."""
        lo, hi = bounds[i]
        _DRAW_SIGS.add((hi - lo, n, cfg.drop_prob, D, sampler))
        with maybe_span(tel, "draw_enqueue", track="control", chunk=i):
            dsts, arrivals = _draw_chunk(
                keys[lo:hi], torch.as_tensor(online_mat[lo:hi], device=dev),
                lo, n=n, drop=cfg.drop_prob, delay_max=D, sampler=sampler)
            mask = arrivals >= 0 if codec.ef else None
            if mask is not None and shard is not None:
                mask = mask[:, shard.lo:shard.hi].contiguous()
        with maybe_span(tel, "draw_readback", track="device", chunk=i):
            return dsts.cpu().numpy(), arrivals.cpu().numpy(), mask

    def pack(i, win, multi, recv, stats, arrivals):
        """Chunk i's packing (the reference's choice, or ``compact_mode``)
        and its host tables, with each cycle's real lengths (the tables
        grouped by node shard under a mesh)."""
        T, K = len(recv), k_rounds
        senders = []

        def sender_lists():
            if not senders:
                senders.append([np.flatnonzero(arrivals[t] >= 0)
                                .astype(np.int32) for t in range(T)])
            return senders[0]

        send_width = lambda: bucket("send", shard_list_width(  # noqa: E731
            sender_lists(), n, shards))
        wm = bucket("compact", shard_list_width(multi, n, shards))
        w1 = bucket("compact_all", shard_list_width(recv, n, shards))
        mode, ws = choose_packing(K, n, stats["multi_sizes"],
                                  stats["recv_sizes"], wm, w1, send_width,
                                  shards)
        mode = compact_mode or mode
        if mode == "compact":
            widths["compact"] = wm
            return mode, pack_compact_rounds(win, multi, T, K, n, wm,
                                             shards), (stats["multi_sizes"],)
        if mode == "compact_all":
            widths["compact_all"] = w1
            widths["send"] = ws = ws or send_width()
            lists = sender_lists()
            return mode, (*pack_compact_all(win, recv, T, K, n, w1, shards),
                          _pack_index_lists(lists, n, ws, shards)), (
                stats["recv_sizes"],
                np.array([r.size for r in lists], np.int64))
        return mode, None, None

    def route(i, drawn):
        lo, hi = bounds[i]
        dsts, arrivals, mask = drawn
        with maybe_span(tel, "route_chunk", track="control", chunk=i):
            win, stats, multi, recv = router.route_chunk(
                dsts, arrivals, online_mat[lo:hi], lo, k_rounds,
                per_cycle_stats=armed)
            stats["recv_sizes"] = np.array([r.size for r in recv], np.int64)
            stats["multi_sizes"] = np.array([r.size for r in multi],
                                            np.int64)
            # Byzantine senders with send_ok (arrival >= 0), off the host
            # table
            stats["corrupted"] = (
                int(byz_np[np.nonzero(arrivals >= 0)[1]].sum())
                if byz_np is not None else 0)
            if armed:
                send_ok = arrivals >= 0
                stats["sent_cycles"] = send_ok.sum(axis=1).astype(np.int64)
                stats["corrupted_cycles"] = (
                    (send_ok & byz_np[None, :]).sum(axis=1).astype(np.int64)
                    if byz_np is not None else np.zeros(hi - lo, np.int64))
        mode, tables, counts = "dense", None, None
        if compact_rounds:
            with maybe_span(tel, "pack_tables", track="control", chunk=i):
                mode, tables, counts = pack(i, win, multi, recv, stats,
                                            arrivals)
        if mode == "dense":
            with maybe_span(tel, "dense_table", track="control", chunk=i):
                tables = ((dense_table(win, hi - lo, k_rounds, n),)
                          if shard is None else
                          (dense_table(shard.own_winners(win), hi - lo,
                                       k_rounds, shard.nl),))
        exchange = None
        if shard is not None:
            tables, counts, plan, remotes = shard.chunk_tables(
                mode, tables, win, hi - lo)
        tables = [torch.from_numpy(a) for a in tables]
        if dev.type == "cuda":
            # pinned + non_blocking: the upload queues behind the device's
            # work instead of making the host wait for it
            with maybe_span(tel, "table_upload", track="control", chunk=i):
                tables = [a.pin_memory().to(dev, non_blocking=True)
                          for a in tables]
        if shard is not None:
            exchange = ChunkExchange(shard, plan, remotes, dev)
        return mode, tables, counts, stats, mask, exchange

    # Draws run one chunk ahead. Chunk i+1's tables are read back before
    # chunk i is enqueued, so the read waits only for chunk i-1, which ran
    # while the host routed chunk i; routing chunk i+1 then overlaps the
    # device's chunk i. The host holds one chunk of draws at a time.
    msg_bytes = message_wire_bytes(d, cfg.wire_dtype)
    in_flight = 0
    evals, screens, ef_rms = [], [], []
    pending = route(0, draw(0))
    for i, p in enumerate(pts):
        mode, tables, counts, stats, mask, exchange = pending
        drawn = draw(i + 1) if i + 1 < len(pts) else None
        lo, hi = bounds[i]
        _chunk_signatures(cfg, D, mode, armed, shards).add((
            tuple(tuple(a.shape) for a in tables), tuple(X.shape),
            tuple(carry.buf_w.shape), str(carry.buf_w.dtype),
            tuple(carry.cache.w.shape), hi - lo))
        with maybe_span(tel, "chunk_dispatch", track="device", chunk=i,
                        mode=mode, cycles=hi - lo):
            _, screen = run_chunk(
                carry, mode, tables, X, y, variant=cfg.variant,
                lam=cfg.lam, learner=cfg.learner, eta=cfg.eta,
                wire=codec.name, keys=keys[lo:hi], send_mask=mask,
                counts=counts, fault_model=cfg.fault_model, byz=byz,
                defense=cfg.defense, per_cycle=armed, exchange=exchange,
                shard=shard)
        screens.append(screen)
        with maybe_span(tel, "eval", track="eval", cycle=p):
            evals.append(evaluate(carry.cache, X_test=X_test, y_test=y_test))
        if armed:
            # queued before chunk i+1 updates the carry; read at the end
            # (under a mesh each node's square, gathered there)
            ef_rms.append(ef_residual_rms(carry.ef) if shard is None
                          else ef_squares(carry.ef))
        if serve_hook is not None:
            with maybe_span(tel, "snapshot", track="serving", cycle=p):
                serve_hook(p, serving.snapshot_from_carry(carry, shard))
        if drawn is not None:
            pending = route(i + 1, drawn)   # overlaps the device's chunk i
        res.sent_total += stats["sent"]
        res.delivered_total += stats["delivered"]
        res.lost_total += stats["lost"]
        res.overflow_total += stats["overflow"]
        res.fault_stats["corrupted"] += stats["corrupted"]
        res.delivered_per_cycle.extend(
            int(x) for x in stats["delivered_cycles"])
        res.cycles.append(p)
        mode_counts[mode] += 1
        occ_recv.append(stats["recv_sizes"])
        occ_multi.append(stats["multi_sizes"])
        if armed:
            sc, dc = stats["sent_cycles"], stats["delivered_cycles"]
            flow = np.cumsum(sc - dc - stats["lost_cycles"]
                             - stats["overflow_cycles"]) + in_flight
            in_flight = int(flow[-1])
            tel.emit_row(
                sent=sc, delivered=dc, lost=stats["lost_cycles"],
                overflow=stats["overflow_cycles"], in_flight=flow,
                wire_bytes=sc * msg_bytes, recv_nodes=stats["recv_sizes"],
                multi_nodes=stats["multi_sizes"],
                online_nodes=online_mat[lo:hi].sum(axis=1),
                corrupted=stats["corrupted_cycles"])
    if shard is not None:
        # the screen's counts of every rank's block (each chunk's (2,)
        # totals, or armed its (T, 2) cycles), in one sum
        rows = [sc.reshape(-1, 2) for sc in screens]
        summed = compat.psum(torch.cat(rows), shard.axis)
        screens = [part.reshape(sc.shape) for part, sc in zip(
            summed.split([r.shape[0] for r in rows]), screens)]
        if armed:
            ef_rms = _gathered_rms(ef_rms, shard)
    with maybe_span(tel, "collect_results", track="device", chunks=len(pts)):
        for err_f, err_v, sim in evals:
            res.err_fresh.append(float(err_f))
            res.err_voted.append(float(err_v))
            res.similarity.append(float(sim))
        for screen in screens:
            if armed:
                per = np.asarray(screen.tolist(), np.int64)     # (T, 2)
                tel.emit("gated", per[:, 0])
                tel.emit("clipped", per[:, 1])
                gated, clipped = (int(v) for v in per.sum(axis=0))
            else:
                gated, clipped = screen.tolist()
            res.fault_stats["gated"] += gated
            res.fault_stats["clipped"] += clipped
        if armed:
            tel.emit("ef_residual_rms",
                     [0.0 if v is None else float(v) for v in ef_rms])
    res.in_flight_total = router.in_flight
    r1 = np.concatenate(occ_recv) / n
    mr = np.concatenate(occ_multi) / n
    res.compaction = dict(
        chunk_modes=dict(mode_counts),
        round1_occupancy_mean=float(r1.mean()),
        round1_occupancy_max=float(r1.max()),
        multi_occupancy_mean=float(mr.mean()),
        multi_occupancy_max=float(mr.max()),
        packed_widths=dict(widths), shards=shards)
    res.wire_bytes_total = res.sent_total * msg_bytes
    if shard is None:
        res.ef_residual_norm = ef_residual_norm(carry.ef)
    elif carry.ef.numel():
        res.ef_residual_norm = float(_gathered_rms([ef_squares(carry.ef)],
                                                   shard)[0])
    if final_state:
        res.final_state = _final_state(carry, shard)
    if armed:
        tel.annotations.setdefault("runs", []).append(dict(
            engine="sharded", n_nodes=n, cycles=cycles,
            wire_dtype=cfg.wire_dtype or "f32", message_bytes=msg_bytes,
            chunk_modes=dict(mode_counts)))
    return res
