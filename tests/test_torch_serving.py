"""The serving tier: the port against the JAX package.

``assign_queries`` and the latency histogram must equal the reference's;
``serve_fresh``, ``serve_voted``, ``serve_voted_kernel`` (the
voted-predict wrapper, its plain version on CPU tensors) and
``voted_predict_batched_plain`` must answer bit for bit as the JAX paths
do on the same snapshot (moved by ``convert.snapshot_from_arrays``),
zero scores and exact-half ties included. A run with a serving hook must
equal a run without one bit for bit on both port engines; the port's
snapshots must equal the JAX reference engine's at every eval point
(integers exactly, floats within ``atol=1e-5, rtol=1e-5``: the receive
step rounds and sums in another order, as ``tests/test_torch_engine.py``
states). A snapshot must be a copy: the sharded engine updates its carry
in place, and a tail batch flushed after the run must still be answered
from its own cycle's snapshot."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gossip_linear import GossipLinearConfig as JConfig
from repro.core import serving as jserving
from repro.core.cache import ModelCache as JCache
from repro.core.simulation import run_simulation as jax_run
from repro.core.telemetry import LatencyHistogram as JHistogram
from repro.data.synthetic import make_linear_dataset
from repro.launch.gossip_serve import GossipServer as JServer
from repro_torch import convert
from repro_torch.configs.gossip_linear import GossipLinearConfig
from repro_torch.core import serving
from repro_torch.core.simulation import run_simulation
from repro_torch.core.telemetry import LatencyHistogram
from repro_torch.kernels import voted_predict as vp
from repro_torch.launch.gossip_serve import GossipServer


def numpy_cache(n, c, d, seed, fill):
    """A cache ring as numpy arrays: ``fill`` "one" (count 1), "partial"
    or "wrapped" (ptr past C); node 0 all zero (every score 0), nodes 1-2
    count 2 and node 3 count 4 with slots steered by ``steer`` rows."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, c, d)).astype(np.float32)
    t = rng.integers(0, 60, size=(n, c)).astype(np.int32)
    if fill == "one":
        count = np.ones(n, np.int32)
        ptr = np.ones(n, np.int32)
    elif fill == "partial":
        count = rng.integers(1, c + 1, size=n).astype(np.int32)
        ptr = count.copy()
    else:
        count = np.full(n, c, np.int32)
        ptr = rng.integers(c + 1, 4 * c, size=n).astype(np.int32)
    return w, t, ptr, count


def steer(w, count, X, assign):
    """Zero scores, exact-half ties and a below-half vote: queries 0-3 to
    nodes 0-3 (node 0 all zero; nodes 1, 2: +x, -x; node 3: +x, -x, -x,
    -x)."""
    c = w.shape[1]
    assign[:4] = np.arange(4)
    w[0] = 0.0
    for node in (1, 2):
        count[node] = min(2, c)
        w[node, 0], w[node, 1 % c] = X[node], -X[node]
    if c >= 4:
        count[3] = 4
        w[3, 0], w[3, 1:4] = X[3], -X[3]


def jax_snapshot(w, t, ptr, count, clock=7):
    return jserving._snapshot(JCache(*(jnp.asarray(a) for a in
                                       (w, t, ptr, count))), jnp.int32(clock))


def port_snapshot(jsnap):
    return convert.snapshot_from_arrays([np.asarray(a) for a in jsnap],
                                        "cpu")


@pytest.mark.parametrize("policy", ["uniform", "round_robin"])
@pytest.mark.parametrize("m,n,seed,offset", [(256, 1000, 0, 0),
                                             (7, 3, 4, 2),
                                             (2048, 1_000_000, 5, 4096),
                                             (1, 1, 9, 1)])
def test_assign_queries_bitwise(policy, m, n, seed, offset):
    got = serving.assign_queries(m, n, policy=policy, seed=seed,
                                 offset=offset)
    want = jserving.assign_queries(m, n, policy=policy, seed=seed,
                                   offset=offset)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="unknown assignment policy"):
        serving.assign_queries(4, 3, policy="nope")


@pytest.mark.parametrize("n,c,d,m,fill", [(8, 4, 8, 8, "one"),
                                          (33, 5, 57, 11, "partial"),
                                          (16, 4, 16, 37, "wrapped"),
                                          (10, 3, 128, 1, "partial"),
                                          (40, 10, 10, 300, "partial")])
def test_served_answers_equal_the_jax_paths(n, c, d, m, fill):
    w, t, ptr, count = numpy_cache(n, c, d, n + d, fill)
    rng = np.random.default_rng(m)
    X = rng.normal(size=(m, d)).astype(np.float32)
    assign = rng.integers(0, n, size=m).astype(np.int32)
    if m >= 4 and fill != "one":
        steer(w, count, X, assign)
    jsnap = jax_snapshot(w, t, ptr, count)
    snap = port_snapshot(jsnap)
    assert snap.clock == 7
    for got, want in zip(snap[:5], jsnap[:5]):
        assert np.array_equal(got.numpy(), np.asarray(want))
    jx, ja = jnp.asarray(X), jnp.asarray(assign)
    tx, ta = torch.from_numpy(X), torch.from_numpy(assign)
    want_v = np.asarray(jserving.serve_voted(jsnap.w, jsnap.count, jx, ja))
    want_k = np.asarray(jserving.serve_voted_kernel(jsnap.w, jsnap.count, jx,
                                                    ja))
    want_f = np.asarray(jserving.serve_fresh(jsnap.fresh_w, jx, ja))
    assert np.array_equal(want_v, want_k)
    before = vp.voted_predict_batched.launches
    a = ta.long()
    for got in (serving.serve_voted(snap.w, snap.count, tx, ta),
                serving.serve_voted_kernel(snap.w, snap.count, tx, ta),
                vp.voted_predict_batched_plain(snap.w[a], snap.count[a], tx),
                vp.voted_predict_batched(snap.w[a], snap.count[a], tx,
                                         torch.arange(m, dtype=torch.int32))):
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want_v)
    assert vp.voted_predict_batched.launches == before      # CPU: plain
    assert np.array_equal(serving.serve_fresh(snap.fresh_w, tx, ta).numpy(),
                          want_f)
    if m >= 4 and fill != "one":
        want = [1.0, 1.0, 1.0, -1.0 if c >= 4 else want_v[3]]
        assert want_v[:4].tolist() == want


def test_voted_predict_wrapper_checks():
    w = torch.zeros((6, 3, 5))
    count = torch.ones(6, dtype=torch.int32)
    X = torch.zeros((4, 5))
    assign = torch.zeros(4, dtype=torch.int32)
    assert vp.voted_predict_batched(w, count, X, assign=assign).shape == (4,)
    cases = [
        ((w, count[:4], X), assign, ValueError),    # 6 rows, 4 counts
        ((w, count, X), assign.long(), TypeError),
        ((w, count.long(), X), assign, TypeError),
        ((w, count, X[:, :4].contiguous()), assign, ValueError),
        ((w.transpose(0, 1).contiguous().transpose(0, 1), count, X), assign,
         ValueError),                           # not contiguous
        ((w[0], count, X), assign, ValueError),
    ]
    for args, a, err in cases:
        with pytest.raises(err):
            vp.voted_predict_batched(*args, assign=a)


def test_latency_histogram_equals_the_reference():
    rng = np.random.default_rng(0)
    samples = np.concatenate([rng.lognormal(-7, 1.5, 500), [3e-7, 250.0],
                              np.full(5, 1e-3)])
    got, want = LatencyHistogram(), JHistogram()
    assert np.array_equal(got.EDGES, want.EDGES) and got.EDGES.size == 65
    got.record_many(samples[:300])
    want.record_many(samples[:300])
    for s in samples[300:]:
        got.record(s)
        want.record(s)
    assert np.array_equal(got.counts, want.counts)
    for q in (0, 1, 50, 90, 99, 99.9, 100):
        assert got.percentile(q) == want.percentile(q)
    assert got.to_dict() == want.to_dict()
    other, jother = LatencyHistogram(), JHistogram()
    other.record(0.5)
    jother.record(0.5)
    assert got.merge(other).to_dict() == want.merge(jother).to_dict()
    assert LatencyHistogram().p99 == 0.0


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


def test_gossip_server_answers_like_the_jax_server():
    """The same snapshot and the same submissions: the same batches,
    assignments and answers (voted and fresh), and reproducible."""
    w, t, ptr, count = numpy_cache(50, 6, 9, 3, "partial")
    jsnap = jax_snapshot(w, t, ptr, count)
    X = np.random.default_rng(4).normal(size=(70, 9)).astype(np.float32)

    def serve(server, snap):
        server.serve_hook(3, snap)
        server.submit(X[:29])
        server.submit(X[29:])
        server.flush()
        return server

    jsrv = serve(JServer(batch_size=16, seed=5), jsnap)
    runs = [serve(GossipServer(batch_size=16, seed=5), port_snapshot(jsnap))
            for _ in range(2)]
    for srv in runs:
        assert [b.size for b in srv.batches] == [b.size for b in
                                                 jsrv.batches]
        for b, jb in zip(srv.batches, jsrv.batches):
            assert b.cycle == jb.cycle == 3
            assert np.array_equal(b.assign, jb.assign)
            assert np.array_equal(b.query_ids, jb.query_ids)
        assert np.array_equal(srv.answers(), jsrv.answers())
        assert np.array_equal(srv.answers_fresh(), jsrv.answers_fresh())
        st = srv.stats()
        assert st.queries == 70 and st.batches == 5
        assert st.latency_hist["count"] == 5 and st.p99_latency_s > 0
    with pytest.raises(RuntimeError, match="no snapshot"):
        GossipServer(batch_size=2).submit(X[:2])


def test_gossip_server_batching_and_order():
    """Submits below batch_size stay pending, crossing it serves exactly
    batch_size, flush pads and serves the tail, and answers() returns
    submission order."""
    w, t, ptr, count = numpy_cache(6, 3, 5, 2, "wrapped")
    snap = port_snapshot(jax_snapshot(w, t, ptr, count))
    srv = GossipServer(batch_size=8, policy="round_robin")
    srv.serve_hook(3, snap)
    X = np.random.default_rng(11).normal(size=(13, 5)).astype(np.float32)
    srv.submit(X[:5])
    assert not srv.batches
    srv.submit(X[5:11])
    assert [b.size for b in srv.batches] == [8]
    srv.submit(X[11:])
    srv.flush()
    assert [b.size for b in srv.batches] == [8, 5]
    assign = serving.assign_queries(16, 6, policy="round_robin")
    padded = np.concatenate([X, np.zeros((3, 5), np.float32)])
    want = serving.serve_voted(snap.w, snap.count, torch.from_numpy(padded),
                               torch.from_numpy(assign))
    assert np.array_equal(srv.answers(), want.numpy()[:13])


# ---------------------------------------------------------------------------
# the engines' hook
# ---------------------------------------------------------------------------


def sim_data(n=96, d=12):
    rng = np.random.default_rng(0)
    X, y = make_linear_dataset(rng, n + 64, d, noise=0.05, separation=3.0)
    return X[:n], y[:n], X[n:], y[n:]


SIM = dict(name="toy", dim=12, n_nodes=96, n_test=64, class_ratio=(1, 1),
           lam=1e-3, variant="mu", cache_size=4, drop_prob=0.5,
           delay_max_cycles=10, online_fraction=0.9)
RUN = dict(cycles=24, eval_every=8, seed=3)


@pytest.mark.parametrize("faults", [False, True])
@pytest.mark.parametrize("engine", ["reference", "sharded"])
def test_hooked_run_equals_unhooked_run(engine, faults):
    cfg = GossipLinearConfig(**SIM, **(dict(
        fault_model="sign_flip", byzantine_frac=0.1, defense="norm_clip")
        if faults else {}))
    X, y, Xt, yt = sim_data()
    srv = GossipServer(batch_size=16, seed=1)

    def hook(cycle, snap):
        srv.serve_hook(cycle, snap)
        srv.submit(Xt[:24])

    kw = dict(engine=engine, device="cpu", **RUN)
    hooked = run_simulation(cfg, X, y, Xt, yt, serve_hook=hook, **kw)
    srv.flush()
    clean = run_simulation(cfg, X, y, Xt, yt, **kw)
    assert srv.stats().queries == 24 * len(hooked.cycles)
    for field in ("err_fresh", "err_voted", "similarity", "fault_stats",
                  "delivered_per_cycle"):
        assert getattr(hooked, field) == getattr(clean, field), field


def test_snapshots_equal_the_jax_reference_engine():
    """At every eval point, both port engines' snapshots against the JAX
    reference engine's (the JAX sharded engine's differ from it on float
    weights: ROADMAP.md queue 3)."""
    X, y, Xt, yt = sim_data()

    def collect(store, to_np):
        return lambda cycle, snap: store.__setitem__(
            cycle, [to_np(a) for a in snap])

    want = {}
    jax_run(JConfig(**SIM), X, y, Xt, yt, serve_hook=collect(want, np.array),
            **RUN)
    assert sorted(want) == [8, 16, 24]
    for engine in ("reference", "sharded"):
        got = {}
        run_simulation(GossipLinearConfig(**SIM), X, y, Xt, yt,
                       engine=engine, device="cpu",
                       serve_hook=collect(got, lambda a: np.array(
                           a.numpy() if torch.is_tensor(a) else a)), **RUN)
        assert sorted(got) == sorted(want)
        for cyc in want:
            for field, a, b in zip(serving.QuerySnapshot._fields, got[cyc],
                                   want[cyc]):
                b = np.asarray(b)
                if b.dtype == np.float32:
                    np.testing.assert_allclose(
                        a, b, rtol=1e-5, atol=1e-5,
                        err_msg=f"{engine} cycle {cyc}: {field}")
                else:
                    assert np.array_equal(a, b), (engine, cyc, field)


def test_a_snapshot_does_not_alias_the_live_carry():
    """The server keeps the first eval point's snapshot and leaves a
    partial batch pending; the run goes on for two more chunks, updating
    the sharded engine's carry in place; the tail batch flushed after the
    run must be answered from the first snapshot as it was."""
    cfg = GossipLinearConfig(**SIM)
    X, y, Xt, yt = sim_data()
    srv = GossipServer(batch_size=32, seed=2)
    expected = {}

    def hook(cycle, snap):
        if srv.snapshot is not None:
            return
        srv.serve_hook(cycle, snap)
        srv.submit(Xt[:20])                      # 20 < 32: stays pending
        assign = serving.assign_queries(32, snap.count.shape[0], seed=2)
        xb = np.concatenate([Xt[:20], np.zeros((12, Xt.shape[1]),
                                               np.float32)])
        expected["answers"] = serving.serve_voted(
            snap.w.clone(), snap.count.clone(), torch.from_numpy(xb),
            torch.from_numpy(assign)).numpy()[:20]
        expected["w"] = snap.w.clone()

    run_simulation(cfg, X, y, Xt, yt, engine="sharded", device="cpu",
                   serve_hook=hook, **RUN)
    assert not srv.batches
    assert torch.equal(srv.snapshot.w, expected["w"])
    srv.flush()
    assert srv.batches[0].cycle == 8
    assert np.array_equal(srv.answers(), expected["answers"])
