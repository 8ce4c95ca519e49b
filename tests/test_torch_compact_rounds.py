"""The compact packings' host side: the port against the JAX package.

The router's per-cycle receiver lists (``route_chunk``'s ``recv`` and
``multi``) and the packing functions (``shard_list_width``,
``_pack_index_lists``, ``_packed_columns``, ``pack_compact_rounds``,
``pack_compact_all``, ``dense_table``) must equal the reference's bit for
bit on random chunks routed by both routers: overflow (few destinations,
K small), offline destinations, delays across chunk boundaries, odd N and
empty cycles. The packing choice must be the reference's: the extreme
scenario picks ``compact``, ``sparse-d0.8-o0.1`` picks ``compact_all``, a
chunk whose receivers fill more than half the population falls back to
``dense`` mid-run (as ``tests/test_compact_rounds.py`` forces it), and
``SimResult.compaction`` equals the JAX sharded engine's default run field
for field. The runs stay bit for bit the port's dense run."""
import numpy as np
import pytest

from repro.configs.gossip_linear import GossipLinearConfig as JConfig
from repro.configs.gossip_linear import with_failure_scenario as jscenario
from repro.core import sharded_engine as jse
from repro.core.simulation import run_simulation as jax_run
from repro.data.synthetic import make_linear_dataset
from repro_torch.configs.gossip_linear import (GossipLinearConfig,
                                               with_failure_scenario)
from repro_torch.core import sharded_engine as pse
from repro_torch.core.simulation import run_simulation

# (n, delay_max, K, destinations a chunk draws from, online share, drop)
ROUTER_CASES = [
    (33, 4, 2, 33, 0.7, 0.3),       # odd N, offline destinations
    (64, 6, 4, 5, 0.9, 0.2),        # overflow: every send to 5 nodes
    (40, 10, 3, 40, 0.5, 0.0),      # long delays across chunk boundaries
    (17, 3, 1, 17, 1.0, 0.95),      # K = 1, mostly empty cycles
    (50, 2, 5, 50, 0.3, 1.0),       # nothing sent: every cycle empty
]


def random_chunks(rng, n, D, dests, online, drop, T=5, chunks=4):
    """Random (dsts, arrivals, online rows) chunks as ``_draw_chunk`` and
    the churn trace give them: arrival = clock + delay where the node
    sends, -1 where it is offline, drops or would send to itself."""
    for c in range(chunks):
        clock0 = c * T
        dst = rng.integers(0, dests, size=(T, n)).astype(np.int32)
        on = rng.random((T, n)) < online
        delay = rng.integers(1, D + 1, size=(T, n))
        ok = on & (rng.random((T, n)) >= drop) & (dst != np.arange(n))
        arr = np.where(ok, clock0 + np.arange(T)[:, None] + delay, -1)
        yield clock0, dst, arr.astype(np.int32), on


@pytest.mark.parametrize("case", ROUTER_CASES, ids=lambda c: "-".join(
    map(str, c)))
def test_router_lists_and_packings_equal_the_reference(case):
    n, D, K, dests, online, drop = case
    rng = np.random.default_rng(n * 7 + D)
    jr, pr = jse._HostRouter(n, D), pse._HostRouter(D)
    for clock0, dst, arr, on in random_chunks(rng, n, D, dests, online,
                                              drop):
        T = dst.shape[0]
        jw, jstats, jmulti, jrecv = jr.route_chunk(dst, arr, on, clock0, K,
                                                   per_cycle_stats=True)
        pw, pstats, pmulti, precv = pr.route_chunk(dst, arr, on, clock0, K,
                                                   per_cycle_stats=True)
        for a, b in zip(pw, jw):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert set(pstats) == set(jstats)
        for key, val in jstats.items():
            assert np.array_equal(pstats[key], val), key
        for p_lists, j_lists in ((pmulti, jmulti), (precv, jrecv)):
            assert len(p_lists) == len(j_lists) == T
            for a, b in zip(p_lists, j_lists):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        assert pr.in_flight == jr.p_slot.size
        assert np.array_equal(pse.dense_table(pw, T, K, n),
                              jse.dense_table(jw, T, K, n))
        for lists in (precv, pmulti, [np.flatnonzero(arr[t] >= 0)
                                      .astype(np.int32) for t in range(T)]):
            w = pse.shard_list_width(lists, n, 1)
            assert w == jse.shard_list_width(lists, n, 1)
            assert np.array_equal(pse._pack_index_lists(lists, n, w + 2, 1),
                                  jse._pack_index_lists(lists, n, w + 2, 1))
        w1 = max(jse.shard_list_width(jrecv, n, 1), 1) + 1
        for a, b in zip(pse.pack_compact_all(pw, precv, T, K, n, w1),
                        jse.pack_compact_all(jw, jrecv, T, K, n, w1, 1)):
            assert np.array_equal(a, b)
        if K > 1:
            wm = max(jse.shard_list_width(jmulti, n, 1), 1)
            for a, b in zip(pse.pack_compact_rounds(pw, pmulti, T, K, n, wm),
                            jse.pack_compact_rounds(jw, jmulti, T, K, n, wm,
                                                    1)):
                assert np.array_equal(a, b)
        t_w, dst_w = pw[0], pw[2]
        assert np.array_equal(
            pse._packed_columns(precv, t_w, dst_w, n, w1, 1),
            jse._packed_columns(jrecv, t_w, dst_w, n, w1, 1))


def test_compact_all_tables_encode_the_dense_table():
    """Every receive of the dense table sits at its receiver's packed
    column, and the padding is inert (the reference's own check, on the
    port's functions)."""
    rng = np.random.default_rng(0)
    T, K, n = 3, 4, 32
    src = np.full((T, K, n), -1, np.int32)
    for t in range(T):
        for j, node in enumerate(rng.choice(n, size=10, replace=False)):
            src[t, :1 + j % K, node] = rng.integers(0, 64, size=1 + j % K)
    recv = [np.flatnonzero(src[t, 0] >= 0).astype(np.int32)
            for t in range(T)]
    t_w, r_w, dst_w = (a.astype(np.int32) for a in np.nonzero(src >= 0))
    win = (t_w, r_w, dst_w, src[t_w, r_w, dst_w])
    width = max(r.size for r in recv) + 3
    ridx, rslot = pse.pack_compact_all(win, recv, T, K, n, width)
    for t in range(T):
        r = recv[t]
        assert np.array_equal(ridx[t, :r.size], r)
        assert np.all(ridx[t, r.size:] == -1)
        assert np.all(rslot[t, :, r.size:] == -1)
        for k in range(K):
            assert np.array_equal(rslot[t, k, :r.size], src[t, k, r])


def toy(n, d=12, seed=0):
    rng = np.random.default_rng(seed)
    X, y = make_linear_dataset(rng, n + 48, d, noise=0.05, separation=3.0)
    return X[:n], y[:n], X[n:], y[n:]


def configs(n, scenario, d=12, **kw):
    base = dict(name="prop", dim=d, n_nodes=n, n_test=48,
                class_ratio=(1, 1), lam=1e-3, variant="mu", **kw)
    return (with_failure_scenario(GossipLinearConfig(**base), scenario),
            jscenario(JConfig(**base), scenario))


def bitwise(a, b):
    """Two port runs give the same bits: curves, economy, fault counters,
    the EF norm."""
    assert a.cycles == b.cycles
    assert (a.err_fresh, a.err_voted, a.similarity) == (
        b.err_fresh, b.err_voted, b.similarity)
    assert (a.sent_total, a.delivered_total, a.lost_total, a.overflow_total,
            a.in_flight_total, a.delivered_per_cycle) == (
        b.sent_total, b.delivered_total, b.lost_total, b.overflow_total,
        b.in_flight_total, b.delivered_per_cycle)
    assert a.fault_stats == b.fault_stats
    assert a.ef_residual_norm == b.ef_residual_norm


@pytest.mark.parametrize("scenario,n,want", [
    ("extreme", 96, "compact"), ("sparse-d0.8-o0.1", 256, "compact_all")])
def test_the_chooser_picks_the_reference_packing(scenario, n, want):
    """The extreme scenario picks ``compact``, the sparse one
    ``compact_all``; ``compaction`` equals the JAX sharded engine's
    default run field for field, and the run equals the port's dense run
    bit for bit."""
    X, y, Xt, yt = toy(n)
    pcfg, jcfg = configs(n, scenario)
    kw = dict(cycles=30, eval_every=10, seed=2)
    jsh = jax_run(jcfg, X, y, Xt, yt, engine="sharded", **kw)
    auto = run_simulation(pcfg, X, y, Xt, yt, engine="sharded",
                          device="cpu", **kw)
    dense = run_simulation(pcfg, X, y, Xt, yt, engine="sharded",
                           device="cpu", compact_mode="dense", **kw)
    assert auto.compaction == jsh.compaction
    assert auto.compaction["chunk_modes"][want] == len(auto.cycles)
    bitwise(auto, dense)
    assert dense.compaction["chunk_modes"] == {
        "dense": len(dense.cycles), "compact": 0, "compact_all": 0}


def test_mid_run_fall_back_to_dense(monkeypatch):
    """A middle chunk whose receiver lists claim the whole population
    leaves compact_all for dense, as in the reference's test, and the run
    stays the dense run bit for bit (the claimed lists only change the
    choice: the tables are built from the winners)."""
    n = 64
    X, y, Xt, yt = toy(n)
    pcfg, _ = configs(n, "sparse-d0.8-o0.1")
    kw = dict(cycles=24, eval_every=8, seed=5, engine="sharded",
              device="cpu")
    dense = run_simulation(pcfg, X, y, Xt, yt, compact_mode="dense", **kw)
    orig = pse._HostRouter.route_chunk
    calls = []

    def fake(self, *args, **kwargs):
        win, stats, multi, recv = orig(self, *args, **kwargs)
        if len(calls) == 1:
            full = [np.arange(n, dtype=np.int32)] * len(recv)
            multi, recv = full, full
        calls.append(0)
        return win, stats, multi, recv

    monkeypatch.setattr(pse._HostRouter, "route_chunk", fake)
    r = run_simulation(pcfg, X, y, Xt, yt, **kw)
    modes = r.compaction["chunk_modes"]
    assert modes["dense"] == 1 and modes["compact_all"] == 2, modes
    assert r.compaction["round1_occupancy_max"] == 1.0
    bitwise(r, dense)


def test_forced_packings_past_the_gate_and_the_options():
    """``compact_mode`` forces a packing even past the N/2 gate (the clean
    scenario, where nearly every node receives), ``compact_rounds=False``
    keeps every chunk dense, and the reference's refusals hold."""
    n = 48
    X, y, Xt, yt = toy(n)
    pcfg, _ = configs(n, "clean")
    kw = dict(cycles=12, eval_every=6, seed=1, engine="sharded",
              device="cpu")
    dense = run_simulation(pcfg, X, y, Xt, yt, compact_rounds=False, **kw)
    assert dense.compaction["chunk_modes"]["dense"] == 2
    assert dense.compaction["round1_occupancy_max"] > 0.5
    for mode in ("compact", "compact_all"):
        r = run_simulation(pcfg, X, y, Xt, yt, compact_mode=mode, **kw)
        assert r.compaction["chunk_modes"][mode] == 2
        bitwise(r, dense)
    with pytest.raises(ValueError, match="unknown compact_mode"):
        run_simulation(pcfg, X, y, Xt, yt, compact_mode="sparse", **kw)
    with pytest.raises(ValueError, match="k_rounds > 1"):
        run_simulation(pcfg, X, y, Xt, yt, compact_mode="compact",
                       k_rounds=1, **kw)


def test_zero_delivery_chunks_are_inert():
    """drop = 1: every table is padding, and the packings stay inert."""
    n = 33
    X, y, Xt, yt = toy(n)
    pcfg = GossipLinearConfig(name="prop", dim=12, n_nodes=n, n_test=48,
                              class_ratio=(1, 1), lam=1e-3, variant="mu",
                              drop_prob=1.0, delay_max_cycles=4,
                              online_fraction=0.5)
    kw = dict(cycles=12, eval_every=6, seed=7, engine="sharded",
              device="cpu")
    dense = run_simulation(pcfg, X, y, Xt, yt, compact_mode="dense", **kw)
    for mode in ("compact", "compact_all", None):
        r = run_simulation(pcfg, X, y, Xt, yt, compact_mode=mode, **kw)
        bitwise(r, dense)
        assert r.delivered_total == 0
        assert r.compaction["round1_occupancy_max"] == 0.0


def test_the_packing_span_stands_beside_dense_table():
    """Armed, a compacting run times its packing in ``pack_tables``, one a
    chunk, and builds ``dense_table`` only for its dense chunks."""
    from repro_torch.core.telemetry import Telemetry

    n = 96
    X, y, Xt, yt = toy(n)
    pcfg, _ = configs(n, "extreme")
    tel = Telemetry()
    r = run_simulation(pcfg, X, y, Xt, yt, engine="sharded", device="cpu",
                       cycles=20, eval_every=10, seed=3, telemetry=tel)
    names = [s.name for s in tel.spans]
    assert names.count("pack_tables") == len(r.cycles)
    assert names.count("dense_table") == r.compaction["chunk_modes"]["dense"]
