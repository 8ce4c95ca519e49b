"""Protocol simulator for gossip learning (Algorithm 1): the reference
engine.

Counterpart of ``repro/core/simulation.py`` on every registered wire codec
(``repro_torch.core.wire_codec``) and fault model (``repro_torch.core.
faults``): one Python-driven cycle at a time over the whole population,
with message drop, delay quantized to whole cycles, lognormal churn and a
per-node model cache. Simultaneous arrivals at one node are applied in K
winner-per-destination rounds, each screened by the configured defense.
Messages are encoded at send time (``fresh + ef`` for the error-feedback
codecs, the cycle's ``k_recv`` key for ``int8_sr``) and decoded before the
f32 merge; a Byzantine sender corrupts its model before the encode or its
payload after it. For a given seed it draws the same threefry values as
the JAX package (``repro_torch.random``), so the message economy and the
fault counters are exactly the reference's and the error curves agree.
At every eval point a ``serve_hook`` receives a ``QuerySnapshot`` of the
live state (``repro_torch.core.serving``).

On the card this engine is the oracle that ``chip_smoke.py`` holds the
kernel path of ``repro_torch.core.sharded_engine`` against.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import random
from repro_torch.configs.gossip_linear import GossipLinearConfig
from repro_torch.core import cache as cache_mod
from repro_torch.core import faults as faults_mod
from repro_torch.core import peer_sampling, serving
from repro_torch.core.cache import ModelCache
from repro_torch.core.learners import LinearModel, make_update
from repro_torch.core.merge import create_model
from repro_torch.core.telemetry import maybe_span
from repro_torch.core.wire_codec import get_codec
from repro_torch.utils.device import resolve_device
from repro_torch.utils.metrics import cosine_similarity


class SimState(NamedTuple):
    last_w: torch.Tensor       # (N, d)  lastModel
    last_t: torch.Tensor       # (N,)
    cache: ModelCache
    buf_w: torch.Tensor        # (D, N, P) in-flight payloads, slot = cycle % D
    #                            (P = codec.payload_cols(d), codec dtype)
    buf_t: torch.Tensor        # (D, N)
    buf_scale: torch.Tensor    # (D, N) f16 per-message scale  ((0, 0) when
    buf_zp: torch.Tensor       # (D, N) f16 zero-point          not carried)
    buf_dst: torch.Tensor      # (D, N) int32 destination
    buf_arrival: torch.Tensor  # (D, N) int32 absolute arrival cycle, -1 = none
    ef: torch.Tensor           # (N, d) f32 sender EF residual ((0, 0) if none)
    clock: int


def init_state(n: int, d: int, cache_size: int, delay_max: int, device,
               wire_dtype=None) -> SimState:
    """The all-zero population at cycle 0. The payload buffer is in the
    wire codec's representation; the scale, zero-point and EF lanes are
    (0, 0) where the codec does not carry them."""
    codec = get_codec(wire_dtype)
    z = functools.partial(torch.zeros, device=device)
    lane = lambda has, shape: shape if has else (0, 0)
    return SimState(
        last_w=z((n, d), dtype=torch.float32),
        last_t=z((n,), dtype=torch.int32),
        cache=cache_mod.init_cache(n, cache_size, d, device),
        buf_w=z((delay_max, n, codec.payload_cols(d)),
                dtype=codec.payload_dtype),
        buf_t=z((delay_max, n), dtype=torch.int32),
        buf_scale=z(lane(codec.has_scale, (delay_max, n)),
                    dtype=torch.float16),
        buf_zp=z(lane(codec.has_zp, (delay_max, n)), dtype=torch.float16),
        buf_dst=z((delay_max, n), dtype=torch.int32),
        buf_arrival=torch.full((delay_max, n), -1, dtype=torch.int32,
                               device=device),
        ef=z(lane(codec.ef, (n, d)), dtype=torch.float32),
        clock=0,
    )


def check_slice(cfg: GossipLinearConfig) -> None:
    """Raise for unknown codec, fault and defense names with the
    reference's messages (``byzantine_frac`` is checked where the mask is
    drawn, as there)."""
    get_codec(cfg.wire_dtype)          # unknown codec names raise ValueError
    faults_mod.check_defense(cfg.defense)
    faults_mod.get_fault(cfg.fault_model)


def select_receivers(buf_dst, buf_arrival, online, clock: int,
                     k_rounds: int):
    """Winner-per-destination selection for up to ``k_rounds`` receives:
    in round k a node accepts the due message with the k-th largest flat
    slot id. Returns ``(src_slot, valid, delivered, overflow, lost)`` with
    ``src_slot`` (K, N) int64 into the flattened buffer and ``valid`` (K, N)
    bool; the three counts are 0-dim tensors."""
    D, n = buf_dst.shape
    flat_dst = buf_dst.reshape(-1).long()
    flat_arr = buf_arrival.reshape(-1)
    due = flat_arr == clock
    dst_on = online[flat_dst]
    arriving = due & dst_on
    lost = (due & ~dst_on).sum()
    slot_ids = torch.arange(1, D * n + 1, dtype=torch.int32,
                            device=buf_dst.device)
    remaining = arriving
    delivered = torch.zeros((), dtype=torch.int64, device=buf_dst.device)
    slots, valids = [], []
    for _ in range(k_rounds):
        tag = torch.where(remaining, slot_ids, 0)
        taken = torch.zeros(n, dtype=torch.int32, device=buf_dst.device)
        taken = taken.scatter_reduce(0, flat_dst, tag, "amax")
        valids.append(taken > 0)
        slots.append(torch.clamp_min(taken - 1, 0).long())
        taken_at = taken[flat_dst]
        win = remaining & (tag == taken_at) & (taken_at > 0)
        remaining = remaining & ~win
        delivered = delivered + win.sum()
    overflow = remaining.sum()
    return (torch.stack(slots), torch.stack(valids), delivered, overflow,
            lost)


def apply_receives(last_w, last_t, cache: ModelCache, msg_w, msg_t, valid,
                   X, y, *, variant: str, update, defense: str = "none"):
    """Up to K sequential receives per node (Algorithm 1 ON RECEIVE): for
    each valid (node, round) ``modelCache.add(createModel(m, lastModel));
    lastModel <- m``. msg_w: (K, N, d); msg_t, valid: (K, N).

    ``defense`` screens each round's payload against the receiver's current
    lastModel (``faults.apply_defense``) before the merge: a rejected
    message is not received (no cache add, no lastModel change), a clipped
    one is merged and kept rescaled. Returns ``(last_w, last_t, cache,
    gated, clipped)``, the last two per-node int32 counts."""
    gated = torch.zeros(last_t.shape, dtype=torch.int32, device=last_t.device)
    clipped = torch.zeros_like(gated)
    for k in range(msg_w.shape[0]):
        mw, has, g, c = faults_mod.apply_defense(defense, msg_w[k], valid[k],
                                                 last_w)
        gated += g.to(torch.int32)
        clipped += c.to(torch.int32)
        m1 = LinearModel(mw, msg_t[k])
        m2 = LinearModel(last_w, last_t)
        new = create_model(variant, update, m1, m2, X, y)
        cache = cache_mod.cache_add(cache, has, new.w, new.t)
        last_w = torch.where(has[:, None], m1.w, last_w)
        last_t = torch.where(has, m1.t, last_t)
    return last_w, last_t, cache, gated, clipped


def draw_sends(key, n: int, clock: int, online, *, drop: float,
               delay_max: int, sampler: str):
    """One cycle's send draws, in ``cycle_core``'s order: split the cycle
    key into 4 (k_recv, k_dst, k_delay, k_drop), then destination, delay
    and drop. Returns ``(dst, arrival)`` (N,) int32 with arrival = -1 where
    the node does not send (offline, dropped, or idle: dst == self)."""
    _, k_dst, k_delay, k_drop = random.split(key, 4)
    if sampler == "matching":
        dst = peer_sampling.perfect_matching(k_dst, n)
    else:
        dst = peer_sampling.uniform_peers(k_dst, n)
    if delay_max > 1:
        delay = random.randint(k_delay, (n,), 1, delay_max + 1)
    else:
        delay = torch.ones(n, dtype=torch.int32, device=dst.device)
    if drop > 0:
        dropped = random.bernoulli(k_drop, drop, (n,))
    else:
        dropped = torch.zeros(n, dtype=torch.bool, device=dst.device)
    idle = dst == torch.arange(n, dtype=dst.dtype, device=dst.device)
    send_ok = online & ~dropped & ~idle
    arrival = torch.where(send_ok, clock + delay, -1).to(torch.int32)
    return dst.to(torch.int32), arrival


def simulate_cycle(state: SimState, X, y, online, key, byz=None, *,
                   variant: str, learner: str, lam: float, eta: float,
                   drop: float, delay_max: int, k_rounds: int, sampler: str,
                   wire_dtype=None, fault_model=None, defense: str = "none",
                   emit_streams: bool = False):
    """One gossip cycle for the whole population. Returns (state, stats):
    over a run ``sum(sent) == sum(delivered + lost + overflow) +
    in-flight``. ``wire_dtype`` names the codec the buffer holds: winners
    are decoded before the merge, and the fresh models (plus the EF
    residual) are encoded on the way out, ``int8_sr`` with ``k_recv`` =
    ``split(key, 4)[0]``; the residual refreshes only where the node
    sends.

    ``fault_model`` with ``byz`` (the (N,) Byzantine mask): a model-kind
    fault rewrites the Byzantine senders' model before the encode, the
    wire-kind ``bitflip`` their payload after it (and after the EF
    residual, which stays the honest encoder's). Fault draws use
    ``fault_key(key)``. A gated message still counts as delivered; the
    stats add ``corrupted`` (Byzantine senders that sent), ``gated`` and
    ``clipped``.

    ``emit_streams`` (set by an armed ``telemetry=``) adds the receiver
    occupancy streams: ``recv_nodes``, the round-1 winners, and
    ``multi_nodes``, round 2's (0 when K = 1). Unarmed, the cycle does no
    extra work."""
    n, d = state.last_w.shape
    D = delay_max
    codec = get_codec(wire_dtype)
    fault = faults_mod.get_fault(fault_model)
    update = make_update(learner, lam=lam, eta=eta)
    if X.ndim == 3:                   # multi-record nodes: clock-th record
        rec = state.clock % X.shape[1]
        X = X[:, rec, :]
        y = y[:, rec]

    src_slot, valid, delivered, overflow, lost = select_receivers(
        state.buf_dst, state.buf_arrival, online, state.clock, k_rounds)
    payload = state.buf_w.reshape(-1, state.buf_w.shape[-1])[src_slot]
    msc = state.buf_scale.reshape(-1)[src_slot] if codec.has_scale else None
    mzp = state.buf_zp.reshape(-1)[src_slot] if codec.has_zp else None
    msg_w = codec.decode(payload, msc, mzp, d)           # (K, N, d) winners
    msg_t = state.buf_t.reshape(-1)[src_slot]
    last_w, last_t, cache, gated, clipped = apply_receives(
        state.last_w, state.last_t, state.cache, msg_w, msg_t, valid, X, y,
        variant=variant, update=update, defense=defense)

    send_w, send_t = cache_mod.freshest(cache)
    if fault is not None and fault.kind == "model":
        old_w, old_t = (cache_mod.cache_oldest(cache)
                        if fault.name == "stale_replay" else (None, None))
        send_w, send_t = faults_mod.corrupt_model(
            fault, byz, faults_mod.fault_key(key), send_w, send_t, old_w,
            old_t)
    dst, arrival = draw_sends(key, n, state.clock, online, drop=drop,
                              delay_max=D, sampler=sampler)
    send_ok = arrival >= 0
    x_send = send_w + state.ef if codec.ef else send_w
    k_recv = random.split(key, 4)[0] if codec.stochastic else None
    q, sc, zp = codec.encode(x_send, key=k_recv)
    ef = state.ef
    if codec.ef:
        ef = torch.where(send_ok[:, None], x_send - codec.decode(q, sc, zp, d),
                         ef)
    if fault is not None and fault.kind == "wire":
        q = faults_mod.bitflip_payload(byz, faults_mod.fault_key(key), q)
    slot = state.clock % D
    buf_w, buf_t = state.buf_w.clone(), state.buf_t.clone()
    buf_scale, buf_zp = state.buf_scale.clone(), state.buf_zp.clone()
    buf_dst, buf_arrival = state.buf_dst.clone(), state.buf_arrival.clone()
    buf_w[slot] = q
    buf_t[slot] = send_t
    if codec.has_scale:
        buf_scale[slot] = sc
    if codec.has_zp:
        buf_zp[slot] = zp
    buf_dst[slot] = dst
    buf_arrival[slot] = arrival
    corrupted = ((byz & send_ok).sum() if fault is not None
                 else torch.zeros((), dtype=torch.int64))
    stats = {"delivered": delivered, "overflow": overflow,
             "sent": send_ok.sum(), "lost": lost, "corrupted": corrupted,
             "gated": gated.sum(), "clipped": clipped.sum()}
    if emit_streams:
        stats["recv_nodes"] = valid[0].sum()
        stats["multi_nodes"] = (valid[1].sum() if k_rounds > 1
                                else torch.zeros((), dtype=torch.int64))
    return SimState(last_w, last_t, cache, buf_w, buf_t, buf_scale, buf_zp,
                    buf_dst, buf_arrival, ef, state.clock + 1), stats


# ---------------------------------------------------------------------------
# churn traces (numpy, a copy of the reference's trace version 2)
# ---------------------------------------------------------------------------


CHURN_TRACE_VERSION = 2


def churn_trace(rng: np.random.Generator, n: int, cycles: int,
                online_fraction: float, mean_online: float = 50.0,
                sigma: float = 1.5) -> np.ndarray:
    """(cycles, N) boolean online matrix from alternating lognormal sessions
    (the Stutzbach-Rejaie churn model), offline durations scaled so the
    stationary online fraction is ``online_fraction``. Consumes ``rng``
    exactly like ``repro.core.simulation.churn_trace`` (version 2), so a
    seed gives the same trace in both packages."""
    if online_fraction >= 1.0:
        return np.ones((cycles, n), dtype=bool)
    if cycles == 0:
        return np.zeros((0, n), dtype=bool)
    mean_off = mean_online * (1.0 - online_fraction) / online_fraction
    mu_on = np.log(mean_online) - sigma ** 2 / 2
    mu_off = np.log(max(mean_off, 1e-9)) - sigma ** 2 / 2
    phase = rng.integers(0, max(int(mean_online), 1), size=n)
    state0 = rng.random(n) < online_fraction

    med_pair = np.exp(mu_on) + np.exp(mu_off)
    horizon = cycles + int(mean_online)
    step = int(np.clip(np.ceil(horizon / max(med_pair, 1.0)) + 2, 4, 4096))

    def draw_sessions(cols_done: int, m: int, init_state) -> np.ndarray:
        # session j has state init ^ (j odd); durations = max(1, int(lognormal))
        j = cols_done + np.arange(m)
        on = init_state[:, None] ^ (j[None, :] % 2 == 1)
        mu = np.where(on, np.float32(mu_on), np.float32(mu_off))
        z = rng.standard_normal((init_state.size, m), dtype=np.float32)
        return np.maximum(np.exp(mu + np.float32(sigma) * z).astype(np.int32), 1)

    # counts[c, i] = session boundaries of node i at cycle c; boundaries at
    # or before cycle 0 only flip the cycle-0 state (flip0)
    counts = np.zeros((cycles, n), np.int16)
    flip0 = np.zeros(n, bool)

    def scatter_boundaries(node_ids, bounds):
        r, c = np.nonzero((bounds > 0) & (bounds < cycles))
        np.add.at(counts, (bounds[r, c], node_ids[r]), 1)
        flip0[node_ids] ^= ((bounds <= 0).sum(axis=1) & 1).astype(bool)

    bounds = draw_sessions(0, step, state0).cumsum(axis=1) - phase[:, None]
    scatter_boundaries(np.arange(n), bounds)
    last = bounds[:, -1]
    sub = np.flatnonzero(last < cycles)
    lsub = last[sub]
    cols = step
    while sub.size:
        bounds = (lsub[:, None]
                  + draw_sessions(cols, step, state0[sub]).cumsum(axis=1))
        scatter_boundaries(sub, bounds)
        cols += step
        lsub = bounds[:, -1]
        keep = lsub < cycles
        sub, lsub = sub[keep], lsub[keep]

    parity = counts.cumsum(axis=0, dtype=np.int16) & 1
    return (state0 ^ flip0)[None, :] ^ parity.astype(bool)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


@dataclass
class SimResult:
    cycles: List[int]
    err_fresh: List[float]      # PREDICT, mean over eval nodes
    err_voted: List[float]      # VOTEDPREDICT, mean over eval nodes
    similarity: List[float]     # mean pairwise cosine over eval-node models
    overflow_total: int
    config: GossipLinearConfig
    sent_total: int = 0
    delivered_total: int = 0
    lost_total: int = 0         # arrived while destination offline
    # messages sent but not yet due when the run ends; the economy is
    # sent_total == delivered + lost + overflow + in_flight_total
    in_flight_total: int = 0
    wire_bytes_total: int = 0
    buf_payload_bytes: int = 0
    delivered_per_cycle: List[int] = field(default_factory=list)
    compaction: Dict[str, object] = field(default_factory=dict)
    # root-mean L2 norm of the per-node EF residual at the end of the run
    # (0.0 for codecs without EF state)
    ef_residual_norm: float = 0.0
    # Byzantine sends, and messages the defense rejected and rescaled
    fault_stats: Dict[str, int] = field(default_factory=lambda: {
        "corrupted": 0, "gated": 0, "clipped": 0})
    # every node's final lanes on the host, where the sharded engine was
    # asked for them (``final_state=True``)
    final_state: Optional[Dict[str, torch.Tensor]] = None


def ef_squares(ef) -> Optional[torch.Tensor]:
    """Each node's squared L2 norm of the EF residual lane (queued, not
    waited for); None for the empty lane of a codec without EF state."""
    if ef.numel() == 0:
        return None
    return torch.sum(ef.to(torch.float32) ** 2, dim=-1)


def ef_residual_rms(ef) -> Optional[torch.Tensor]:
    """Root-mean-square per-node L2 norm of the EF residual lane, as a
    0-dim tensor on its device (queued, not waited for); None for the
    empty lane of a codec without EF state."""
    sq = ef_squares(ef)
    return None if sq is None else torch.sqrt(torch.mean(sq))


def ef_residual_norm(ef) -> float:
    """:func:`ef_residual_rms` as a float (0.0 without EF state)."""
    rms = ef_residual_rms(ef)
    return 0.0 if rms is None else float(rms)


def message_wire_bytes(d: int, wire_dtype_name) -> int:
    """Bytes per transmitted model: the codec's packed coefficients, the
    int32 counter and the codec's scale (and zero-point) bytes."""
    codec = get_codec(wire_dtype_name)
    return codec.payload_bytes(d) + 4 + codec.overhead_bytes


def payload_buffer_bytes(delay_max: int, n: int, d: int,
                         wire_dtype_name) -> int:
    """Footprint of the in-flight (D, N, P) payload buffer in the codec's
    representation, with its (D, N) f16 scale and zero-point lanes (the EF
    residual is sender state and is not counted)."""
    codec = get_codec(wire_dtype_name)
    return delay_max * n * (codec.payload_bytes(d) + codec.overhead_bytes)


@functools.lru_cache(maxsize=2)
def _host_scenario(seed: int, n: int, cycles: int, online_fraction: float,
                   eval_nodes: int):
    """Memoized host-side scenario draw (churn trace, eval subset); callers
    treat the returned arrays as read-only."""
    rng = np.random.default_rng(seed)
    online_mat = churn_trace(rng, n, cycles, online_fraction)
    eval_idx = rng.choice(n, size=min(eval_nodes, n), replace=False)
    return online_mat, eval_idx


def sim_setup(cfg: GossipLinearConfig, X, y, X_test, y_test, *, cycles: int,
              seed: int, eval_nodes: int, device):
    """Shared host-side setup for both engines: the churn trace and the
    eval-node subset come from ONE ``default_rng(seed)`` stream, exactly as
    in the reference, and the data moves to ``device`` as float32."""
    n = X.shape[0]
    online_mat, eval_idx = _host_scenario(seed, n, cycles,
                                          cfg.online_fraction, eval_nodes)
    f32 = functools.partial(torch.as_tensor, dtype=torch.float32,
                            device=device)
    return (online_mat, torch.as_tensor(eval_idx, device=device),
            f32(X), f32(y), f32(X_test), f32(y_test))


def byzantine_tensor(cfg: GossipLinearConfig, seed: int, n: int, device):
    """The run's (N,) bool Byzantine mask on ``device``, or None without a
    fault model (``faults.byzantine_mask``, shared by both engines)."""
    if cfg.fault_model is None:
        return None
    return torch.as_tensor(
        faults_mod.byzantine_mask(seed, n, cfg.byzantine_frac), device=device)


def eval_points(cycles: int, eval_every: int) -> List[int]:
    """The cycle counts after which both engines evaluate the population."""
    return [c + 1 for c in range(cycles)
            if (c + 1) % eval_every == 0 or c == cycles - 1]


def _eval(cache: ModelCache, eval_idx, X_test, y_test):
    """(err_fresh, err_voted, similarity) over the eval nodes, as 0-dim
    tensors on the cache's device."""
    sub = ModelCache(cache.w[eval_idx], cache.t[eval_idx],
                     cache.ptr[eval_idx], cache.count[eval_idx])
    fresh = cache_mod.predict_fresh(sub, X_test)
    voted = cache_mod.voted_predict(sub, X_test)
    err_f = (fresh != y_test[None, :]).to(torch.float32).mean(dim=1).mean()
    err_v = (voted != y_test[None, :]).to(torch.float32).mean(dim=1).mean()
    w, _ = cache_mod.freshest(sub)
    return err_f, err_v, cosine_similarity(w)


def run_simulation(cfg: GossipLinearConfig, X, y, X_test, y_test, *,
                   cycles: int = 200, eval_every: int = 10, seed: int = 0,
                   eval_nodes: int = 100, sampler: str = "uniform",
                   k_rounds: int = 4, engine: str = "reference",
                   serve_hook=None, telemetry=None, device=None,
                   **engine_kwargs) -> SimResult:
    """Run the full protocol for ``cycles`` gossip cycles.

    The entry point for both engines, with the reference's arguments (``X``
    may be (N, d) or (N, k, d) for k records per node) plus ``device``:
    the run happens on the CUDA device unless ``device`` names another
    (``device="cpu"``); without CUDA and without ``device`` it raises.

    ``engine="reference"`` runs this module's Python-driven cycle loop;
    ``engine="sharded"`` runs ``repro_torch.core.sharded_engine`` (host
    router + the fused receive kernel on CUDA), forwarding its extra
    keyword arguments (``mesh=`` and ``node_axis=`` split the nodes over
    the ranks of a ``DeviceMesh`` axis; every rank calls this function
    with the same data). Returns a :class:`SimResult`.

    ``serve_hook``: optional ``hook(cycle, snapshot)``, called at every
    eval point after the eval with a :class:`repro_torch.core.serving.
    QuerySnapshot` of the live state. The snapshot is a copy, so a hooked
    run equals an unhooked one bit for bit.

    ``telemetry``: optional :class:`repro_torch.core.telemetry.Telemetry`.
    Armed, either engine emits the registered per-cycle metric streams
    (bit for bit the JAX reference engine's integers) and times its phases
    as host spans; the run itself is bit for bit the unarmed one."""
    dev = resolve_device(device)
    check_slice(cfg)
    if engine == "sharded":
        from repro_torch.core.sharded_engine import run_sharded_simulation
        return run_sharded_simulation(
            cfg, X, y, X_test, y_test, cycles=cycles, eval_every=eval_every,
            seed=seed, eval_nodes=eval_nodes, sampler=sampler,
            k_rounds=k_rounds, device=dev, serve_hook=serve_hook,
            telemetry=telemetry, **engine_kwargs)
    if engine != "reference":
        raise ValueError(f"unknown engine {engine!r} "
                         "(expected 'reference' or 'sharded')")
    if engine_kwargs:
        raise TypeError("unexpected keyword arguments for the reference "
                        f"engine: {sorted(engine_kwargs)}")

    n, d = X.shape[0], X.shape[-1]
    online_mat, eval_idx, X, y, X_test, y_test = sim_setup(
        cfg, X, y, X_test, y_test, cycles=cycles, seed=seed,
        eval_nodes=eval_nodes, device=dev)
    D = max(cfg.delay_max_cycles, 1)
    state = init_state(n, d, cfg.cache_size, D, dev,
                       wire_dtype=cfg.wire_dtype)
    key = random.key(seed, device=dev)
    byz = byzantine_tensor(cfg, seed, n, dev)

    res = SimResult([], [], [], [], 0, cfg)
    res.buf_payload_bytes = payload_buffer_bytes(D, n, d, cfg.wire_dtype)
    tel = telemetry
    armed = tel is not None
    msg_bytes = message_wire_bytes(d, cfg.wire_dtype)
    in_flight = 0
    for c in range(cycles):
        key, sub = random.split(key)
        with maybe_span(tel, "cycle", track="device", cycle=c):
            online = torch.as_tensor(online_mat[c], device=dev)
            state, stats = simulate_cycle(
                state, X, y, online, sub, byz, variant=cfg.variant,
                learner=cfg.learner, lam=cfg.lam, eta=cfg.eta,
                drop=cfg.drop_prob, delay_max=D, k_rounds=k_rounds,
                sampler=sampler, wire_dtype=cfg.wire_dtype,
                fault_model=cfg.fault_model, defense=cfg.defense,
                emit_streams=armed)
            stats = {k: int(v) for k, v in stats.items()}
        sent, delivered = stats["sent"], stats["delivered"]
        res.sent_total += sent
        res.delivered_total += delivered
        res.delivered_per_cycle.append(delivered)
        res.lost_total += stats["lost"]
        res.overflow_total += stats["overflow"]
        for k in res.fault_stats:
            res.fault_stats[k] += stats[k]
        if armed:
            # reads of the stats the driver fetched anyway
            in_flight += (sent - delivered - stats["lost"]
                          - stats["overflow"])
            tel.emit_row(
                sent=sent, delivered=delivered, lost=stats["lost"],
                overflow=stats["overflow"], in_flight=in_flight,
                wire_bytes=sent * msg_bytes,
                recv_nodes=stats["recv_nodes"],
                multi_nodes=stats["multi_nodes"],
                online_nodes=int(online_mat[c].sum()),
                corrupted=stats["corrupted"], gated=stats["gated"],
                clipped=stats["clipped"])
        if (c + 1) % eval_every == 0 or c == cycles - 1:
            with maybe_span(tel, "eval", track="eval", cycle=c + 1):
                err_f, err_v, sim = _eval(state.cache, eval_idx, X_test,
                                          y_test)
                res.cycles.append(c + 1)
                res.err_fresh.append(float(err_f))
                res.err_voted.append(float(err_v))
                res.similarity.append(float(sim))
            if armed:
                tel.emit("ef_residual_rms", ef_residual_norm(state.ef))
            if serve_hook is not None:
                with maybe_span(tel, "snapshot", track="serving",
                                cycle=c + 1):
                    serve_hook(c + 1, serving.take_snapshot(state))
    res.in_flight_total = int((state.buf_arrival >= state.clock).sum())
    res.wire_bytes_total = res.sent_total * msg_bytes
    res.ef_residual_norm = ef_residual_norm(state.ef)
    if armed:
        tel.annotations.setdefault("runs", []).append(dict(
            engine="reference", n_nodes=n, cycles=cycles,
            wire_dtype=cfg.wire_dtype or "f32", message_bytes=msg_bytes))
    return res
