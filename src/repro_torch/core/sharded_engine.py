"""Mega-population gossip engine (``run_simulation(engine="sharded")``).

Counterpart of ``repro/core/sharded_engine.py`` with the dense packing on
one device, on every wire codec and fault model, with the defense screens
in the receive kernel and a ``serve_hook`` at every eval point. The
protocol is split the way a router splits a network:

* **control plane on the host** — which message reaches which node in which
  round depends only on the threefry draws, the churn matrix and the
  delay/drop outcomes. The engine draws each cycle's destinations and
  arrivals on the device with the same threefry calls as the reference
  engine (``_draw_chunk``), pulls the integer tables to the host and
  resolves the K winner rounds in numpy (``_HostRouter``, a copy of the
  reference's). The message economy falls out of the same pass.
* **data plane on the device** — per chunk of cycles between two eval
  points, a Python loop over the chunk's cycles (the reference's
  ``lax.scan``) gathers the winning payloads (in the wire codec's
  representation, with their scale and zero-point) from the dense
  (T, K, N) routing table, applies the K receives with the fused receive
  kernel, which decodes them (``repro_torch.kernels.gossip_cycle``; its
  plain version on CPU tensors), and refreshes the in-flight buffer row
  with each node's freshest model, encoded by the send kernel
  (``quantize_send``) for the quantized codecs. The carry is updated in
  place, as the JAX chunk function donates it. A Byzantine sender's model
  is corrupted before the encode (or its payload after it) with the
  cycle's ``fault_key``, made on the device for the whole chunk. Launches
  are asynchronous, so routing chunk i+1 on the host overlaps the device's
  work on chunk i; the eval results and the screen's counts are read once,
  after the last chunk. Byzantine sends are counted on the host from the
  arrival table, as the reference's host loop counts them.

Determinism: the same seed gives the same host stream, the same per-cycle
draws and the same winner semantics as both reference engines, so the
economy is exactly theirs and the curves agree.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import random
from repro_torch.configs.gossip_linear import GossipLinearConfig
from repro_torch.core import cache as cache_mod
from repro_torch.core import faults, serving
from repro_torch.core.cache import ModelCache
from repro_torch.core.simulation import (SimResult, _eval, byzantine_tensor,
                                         check_slice, draw_sends,
                                         ef_residual_norm, ef_residual_rms,
                                         eval_points, message_wire_bytes,
                                         payload_buffer_bytes, sim_setup)
from repro_torch.core.telemetry import maybe_span
from repro_torch.core.wire_codec import WireCodec, get_codec
from repro_torch.kernels import gossip_cycle
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

        Returns ``(win, stats)``: the winner tuple ``(t, round, dst, slot)``
        of parallel int32 arrays, and the chunk's message economy with
        ``delivered_cycles``, the (T,) per-cycle delivered counts.

        ``per_cycle_stats`` (armed telemetry only) adds the (T,) per-cycle
        ``lost_cycles`` and ``overflow_cycles``, both counted at the
        arrival cycle as the reference engine counts them, and the round-1
        and round-2 receiver counts ``recv_sizes`` and ``multi_sizes``,
        straight from the winners."""
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
        rank = np.searchsorted(g_s, g_s, side="right") - 1 \
            - np.arange(g_s.size)
        wm = rank < K
        win = (c_t[order][wm].astype(np.int32), rank[wm].astype(np.int32),
               c_dst[order][wm], c_slot[order][wm])
        delivered = int(wm.sum())
        stats = dict(sent=sent, delivered=delivered, lost=lost,
                     overflow=int(g_s.size - delivered),
                     delivered_cycles=np.bincount(
                         win[0], minlength=T).astype(np.int64))
        if per_cycle_stats:
            per_cycle = lambda t: np.bincount(t, minlength=T).astype(np.int64)
            stats["lost_cycles"] = per_cycle(lost_t)
            stats["overflow_cycles"] = per_cycle(c_t[order][~wm])
            stats["recv_sizes"] = per_cycle(win[0][win[1] == 0])
            stats["multi_sizes"] = per_cycle(win[0][win[1] == 1])
        return win, stats

    @property
    def in_flight(self) -> int:
        """Messages sent but not yet due."""
        return int(self.p_slot.size)


_EMPTY_I32 = np.empty(0, np.int32)


def dense_table(win, T: int, K: int, n: int) -> np.ndarray:
    """The dense (T, K, n) routing table from a winner tuple: entry
    [t, r, dst] holds the flat slot id of dst's round-r receive at cycle
    t, -1 = no receive. At N=10^6 it is the router's largest allocation."""
    t_w, r_w, dst_w, slot_w = win
    src_slot = np.full((T, K, n), -1, np.int32)
    src_slot[t_w, r_w, dst_w] = slot_w
    return src_slot


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


def run_dense_chunk(carry: Carry, table, X, y, *, variant: str, lam: float,
                    wire=None, keys=None, send_mask=None, fault_model=None,
                    byz=None, defense: str = "none",
                    per_cycle: bool = False):
    """Run the chunk's cycles over the dense (T, K, N) routing table, in
    place — the reference's ``dense_body`` under ``lax.scan`` with the fused
    receive kernel and, for the quantized codecs, the send kernel.
    ``X``/``y`` are (N, d)/(N,) or (N, k, d)/(N, k) for k records per node
    (cycle c uses record ``c % k``). ``wire`` names the buffer's codec;
    ``int8_sr`` needs ``keys``, the chunk's (T, 2) cycle keys (its noise
    key is ``split(key, 4)[0]``), and the ``_ef`` codecs ``send_mask``, the
    (T, N) ``arrival >= 0`` table: the EF residual refreshes only where a
    node sends. Both stay on the device.

    ``fault_model`` with ``byz`` (the (N,) bool Byzantine mask) corrupts
    the Byzantine rows' transmitted model before the encode (model-kind)
    or their payload after it (``bitflip``), with the fault keys
    ``fold_in(keys, FAULT_FOLD)`` made on the device; ``defense`` is the
    receive kernel's screen. Returns ``(carry, screen)``: ``screen`` is the
    (2,) int64 device tensor of the chunk's gated and clipped totals, or
    with ``per_cycle`` (armed telemetry) the (T, 2) tensor of each cycle's,
    as the reference's armed chunk returns them."""
    codec = get_codec(wire)
    fault = faults.get_fault(fault_model)
    D, n, P = carry.buf_w.shape
    C = carry.cache.w.shape[1]
    rows = torch.arange(n, device=carry.buf_w.device)
    flat_w = carry.buf_w.view(D * n, P)
    flat_t = carry.buf_t.view(D * n)
    flat_sc = carry.buf_scale.view(-1)
    flat_zp = carry.buf_zp.view(-1)
    kr = recv_keys(keys) if codec.stochastic else None
    fk = faults.fault_key(keys) if fault is not None else None
    screen = torch.zeros((table.shape[0], 2) if per_cycle else 2,
                         dtype=torch.int64, device=carry.buf_w.device)
    c = carry.cache
    for t in range(table.shape[0]):
        src = table[t]                                  # (K, n) int32
        idx = torch.clamp_min(src, 0).long()
        valid = (src >= 0).to(torch.int32)
        if X.ndim == 3:
            rec = carry.clock % X.shape[1]
            Xc, yc = X[:, rec, :].contiguous(), y[:, rec].contiguous()
        else:
            Xc, yc = X, y
        out = gossip_cycle.fused_receive_apply(
            carry.last_w, carry.last_t, c.w, c.t, c.ptr, c.count,
            flat_w[idx], flat_t[idx], valid, Xc, yc,
            msg_scale=flat_sc[idx] if codec.has_scale else None,
            msg_zp=flat_zp[idx] if codec.has_zp else None,
            wire=codec.name, variant=variant, lam=lam, defense=defense)
        if defense != "none":
            counts = torch.stack([out[6].sum(), out[7].sum()])
            if per_cycle:
                screen[t] = counts
            else:
                screen += counts
        slot = ((c.ptr - 1) % C).long()                 # freshest slot
        carry.fresh_w = c.w[rows, slot]
        carry.fresh_t = c.t[rows, slot]
        send_w, send_t = carry.fresh_w, carry.fresh_t
        if fault is not None and fault.kind == "model":
            old_w, old_t = (cache_mod.cache_oldest(c)
                            if fault.name == "stale_replay" else (None, None))
            send_w, send_t = faults.corrupt_model(fault, byz, fk[t], send_w,
                                                  send_t, old_w, old_t)
        row = carry.clock % D
        if codec.quantized:
            out = gossip_cycle.quantize_send(
                send_w, codec.name,
                key=kr[t] if codec.stochastic else None,
                ef=carry.ef if codec.ef else None)
            payload = out[0]
            carry.buf_scale[row] = out[1]
            if codec.has_zp:
                carry.buf_zp[row] = out[2]
            if codec.ef:
                carry.ef = torch.where(send_mask[t][:, None], out[2],
                                       carry.ef)
        else:
            payload = send_w               # cast by the buffer-row copy
        if fault is not None and fault.kind == "wire":
            payload = faults.bitflip_payload(
                byz, fk[t], payload.to(codec.payload_dtype))
        carry.buf_w[row] = payload
        carry.buf_t[row] = send_t
        carry.clock += 1
    return carry, screen


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def run_sharded_simulation(cfg: GossipLinearConfig, X, y, X_test, y_test, *,
                           cycles: int = 200, eval_every: int = 10,
                           seed: int = 0, eval_nodes: int = 100,
                           sampler: str = "uniform", k_rounds: int = 4,
                           device=None, use_kernel: Optional[bool] = None,
                           compact_mode: Optional[str] = None, mesh=None,
                           use_send_kernel: Optional[bool] = None,
                           serve_hook=None, telemetry=None) -> SimResult:
    """Run the protocol with the mega-population engine on one device.

    The receive step is the fused kernel on CUDA and its plain version on
    the CPU; ``use_kernel=True`` asserts the kernel (raises on the CPU) and
    ``use_kernel=False`` asserts the plain version (raises on CUDA, where
    the receive step is always the kernel). ``use_send_kernel`` does the
    same for the send kernel of the quantized wire codecs, and is refused
    for the float codecs, which send a plain cast. The reference's other
    options are not ported yet and raise: ``compact_mode`` other than
    "dense" (ROADMAP.md queue 1 item 5), ``mesh`` (queue 1 item 11), and a
    learner other than Pegasos (the vector apply, queue 1 item 5).

    ``serve_hook(cycle, snapshot)`` is called at every eval point with
    ``serving.snapshot_from_carry(carry)``, a copy of the live cache, before
    the next chunk updates the carry in place.

    ``telemetry`` (a :class:`repro_torch.core.telemetry.Telemetry`), when
    armed, gets the reference's per-cycle streams, counted on the host from
    the router's tables, but for the screen's counts, kept per cycle on the
    device and read with the curves after the last chunk, and the EF
    residual's RMS, queued at each eval point before the next chunk runs
    and read there too; and host spans that never nest, one per phase of
    the driver: ``setup``, ``draw_enqueue``, ``draw_readback``,
    ``route_chunk`` (the numpy router alone), ``dense_table``,
    ``table_upload``, ``chunk_dispatch``, ``eval``, ``snapshot`` and
    ``collect_results``. An armed run adds no synchronisation and no kernel
    launch of #1 to #5, and is bit for bit the unarmed run."""
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
    if compact_mode not in (None, "dense"):
        raise NotImplementedError(
            f"compact_mode={compact_mode!r}: the compact packings are "
            "ROADMAP.md queue 1 item 5")
    if mesh is not None:
        raise NotImplementedError("mesh=: node sharding over several devices "
                                  "is ROADMAP.md queue 1 item 11")
    if cfg.learner != "pegasos":
        raise NotImplementedError(
            f"learner={cfg.learner!r} on the sharded engine: the vector "
            "apply for non-Pegasos learners is ROADMAP.md queue 1 item 5")
    check_slice(cfg)
    tel = telemetry
    armed = tel is not None

    with maybe_span(tel, "setup", track="host"):
        n, d = X.shape[0], X.shape[-1]
        D = max(cfg.delay_max_cycles, 1)
        online_mat, eval_idx, X, y, X_test, y_test = sim_setup(
            cfg, X, y, X_test, y_test, cycles=cycles, seed=seed,
            eval_nodes=eval_nodes, device=dev)
        carry = init_carry(n, d, cfg.cache_size, D, dev, codec)
        byz = byzantine_tensor(cfg, seed, n, dev)
        byz_np = None if byz is None else byz.cpu().numpy()
        res = SimResult([], [], [], [], 0, cfg)
        res.buf_payload_bytes = payload_buffer_bytes(D, n, d, cfg.wire_dtype)
        pts = eval_points(cycles, eval_every)
        keys = key_schedule(seed, cycles, dev) if pts else None
    if not pts:
        return res

    router = _HostRouter(D)
    bounds = list(zip([0] + pts[:-1], pts))

    def draw(i):
        """Chunk i's tables on the host, and (for the EF codecs) its send
        mask ``arrival >= 0`` kept on the device: the reference's
        ``send_ok``, without uploading it again."""
        lo, hi = bounds[i]
        with maybe_span(tel, "draw_enqueue", track="control", chunk=i):
            dsts, arrivals = _draw_chunk(
                keys[lo:hi], torch.as_tensor(online_mat[lo:hi], device=dev),
                lo, n=n, drop=cfg.drop_prob, delay_max=D, sampler=sampler)
            mask = arrivals >= 0 if codec.ef else None
        with maybe_span(tel, "draw_readback", track="device", chunk=i):
            return dsts.cpu().numpy(), arrivals.cpu().numpy(), mask

    def route(i, drawn):
        lo, hi = bounds[i]
        dsts, arrivals, mask = drawn
        with maybe_span(tel, "route_chunk", track="control", chunk=i):
            win, stats = router.route_chunk(dsts, arrivals,
                                            online_mat[lo:hi], lo, k_rounds,
                                            per_cycle_stats=armed)
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
        with maybe_span(tel, "dense_table", track="control", chunk=i):
            table = torch.from_numpy(dense_table(win, hi - lo, k_rounds, n))
        if dev.type == "cuda":
            # pinned + non_blocking: the upload queues behind the device's
            # work instead of making the host wait for it
            with maybe_span(tel, "table_upload", track="control", chunk=i):
                table = table.pin_memory().to(dev, non_blocking=True)
        return table, stats, mask

    # Draws run one chunk ahead. Chunk i+1's tables are read back before
    # chunk i is enqueued, so the read waits only for chunk i-1, which ran
    # while the host routed chunk i; routing chunk i+1 then overlaps the
    # device's chunk i. The host holds one chunk of draws at a time.
    msg_bytes = message_wire_bytes(d, cfg.wire_dtype)
    in_flight = 0
    evals, screens, ef_rms = [], [], []
    pending = route(0, draw(0))
    for i, p in enumerate(pts):
        table, stats, mask = pending
        drawn = draw(i + 1) if i + 1 < len(pts) else None
        lo, hi = bounds[i]
        with maybe_span(tel, "chunk_dispatch", track="device", chunk=i,
                        cycles=hi - lo):
            _, screen = run_dense_chunk(
                carry, table, X, y, variant=cfg.variant, lam=cfg.lam,
                wire=codec.name, keys=keys[lo:hi], send_mask=mask,
                fault_model=cfg.fault_model, byz=byz, defense=cfg.defense,
                per_cycle=armed)
        screens.append(screen)
        with maybe_span(tel, "eval", track="eval", cycle=p):
            evals.append(_eval(carry.cache, eval_idx, X_test, y_test))
        if armed:
            # queued before chunk i+1 updates the carry; read at the end
            ef_rms.append(ef_residual_rms(carry.ef))
        if serve_hook is not None:
            with maybe_span(tel, "snapshot", track="serving", cycle=p):
                serve_hook(p, serving.snapshot_from_carry(carry))
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
    res.compaction = dict(chunk_modes={"dense": len(pts)})
    res.wire_bytes_total = res.sent_total * msg_bytes
    res.ef_residual_norm = ef_residual_norm(carry.ef)
    if armed:
        tel.annotations.setdefault("runs", []).append(dict(
            engine="sharded", n_nodes=n, cycles=cycles,
            wire_dtype=cfg.wire_dtype or "f32", message_bytes=msg_bytes,
            chunk_modes=dict(res.compaction["chunk_modes"])))
    return res
