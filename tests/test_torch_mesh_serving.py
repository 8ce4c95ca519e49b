"""Serving and telemetry on the sharded engine's node mesh
(``run_sharded_simulation(mesh=, serve_hook=, telemetry=)``) against the
port's one-device run and the JAX package.

The ranks run in the spawned 2- and 4-rank ``gloo`` groups that the
other ``test_torch_mesh_*.py`` files share
(``tests/torch_mesh_cases.py::serving_ranks``, which imports no JAX), at
the engine cases' sizes (N = 128, d = 16, drop 0.3, delay <= 4, 20
cycles, an eval point every 10): f32 with 25 % sign_flip and norm_clip,
int8_sr and int4_ef, each armed with two ``GossipServer``s (uniform and
round_robin assignment, batches of 16, 20 queries an eval point, so the
second point serves a batch and leaves a padded tail for the flush).
On every rank, bit for bit against the one-device run of the same case
(run in a rank with one thread):

- the snapshot gathered at every eval point (``serving.gather_snapshot``
  of the rank's shard), and each rank's shard placed where its block is;
- every server's voted and fresh answers, its batches (cycle, size,
  assignment, query ids) and its counts: each rank answers the queries
  its nodes own and one sum over the ranks combines them;
- every telemetry stream (``ef_residual_rms`` too: each point's squares
  gathered once after the last chunk) and the run's outcome; and an
  armed, hooked run equals a plain one.

An axis of size 1 runs the one-device path. The spans carry their
rank. Against the JAX package: the JAX sharded engine's integer streams
exactly and its ``ef_residual_rms`` within rtol 1e-4
(``tests/test_torch_telemetry_ef.py``'s bar), and JAX's
``GossipServer``: fed the port's gathered snapshots, every batch and
answer bit for bit; fed the JAX sharded engine's own snapshots, every
assignment equal and the answers within the stated share (the two
engines' weights differ by rounding: ``test_torch_mesh_engine.py``'s
curves are within 0.02).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.gossip_linear import GossipLinearConfig as JConfig
from repro.core import telemetry as jtel
from repro.core.serving import QuerySnapshot as JSnapshot
from repro.core.simulation import run_simulation as jax_run
from repro.launch.gossip_serve import GossipServer as JServer
from repro_torch.core.telemetry import METRIC_STREAMS
from torch_mesh_cases import (POLICIES, RUN, SERVE_BATCH, SERVE_CASES,
                              SERVE_QUERIES, N, engine_config, shared_ranks,
                              toy)

WORLDS = [2, 4]
INT_STREAMS = [n for n, s in METRIC_STREAMS.items() if s.dtype == "int"]
EF_RTOL = 1e-4
# the share of answers that may differ between servers fed the port's
# and the JAX engine's snapshots (measured: none of the 40 of any case
# and policy, voted or fresh; the weights differ by rounding, so a vote
# near its tie may flip)
JAX_SNAPSHOT_FLIPS = 0.05
CASE_IDS = ["-".join(str(v) for v in c.values()) for c in SERVE_CASES]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"W{w}")
def ranks(request, tmp_path_factory):
    out = shared_ranks(tmp_path_factory, request.param)
    return request.param, [r["serving"] for r in out]


def one_device(out, case, world):
    return out[case % world]["one"][case]


def outcome(res):
    """Everything a run reports but the wall clock and the compaction."""
    return (res.cycles, res.err_fresh, res.err_voted, res.similarity,
            res.sent_total, res.delivered_total, res.lost_total,
            res.overflow_total, res.in_flight_total, res.wire_bytes_total,
            res.buf_payload_bytes, res.delivered_per_cycle, res.fault_stats,
            res.ef_residual_norm)


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == \
        b.tobytes()


@pytest.mark.parametrize("case", range(len(SERVE_CASES)), ids=CASE_IDS)
def test_gathered_snapshots_equal_the_one_device_snapshots(ranks, case):
    world, out = ranks
    one = one_device(out, case, world)
    assert sorted(one["snaps"]) == [10, 20]
    for rank in range(world):
        got = out[rank]["mesh"][case]
        assert sorted(got["snaps"]) == sorted(one["snaps"])
        for cyc, lanes in one["snaps"].items():
            for field, a, b in zip(("w", "t", "count", "fresh_w",
                                    "fresh_t"), got["snaps"][cyc], lanes):
                assert same_bits(a, b), (rank, cyc, field)
            assert got["snaps"][cyc][5] == lanes[5] == cyc       # clock
        nl = N // world
        assert got["places"] == [(rank * nl, (rank + 1) * nl, rank, world,
                                  N)] * 2
        assert one["places"] == [None, None]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", range(len(SERVE_CASES)), ids=CASE_IDS)
def test_served_answers_equal_the_one_device_server(ranks, case, policy):
    world, out = ranks
    want = one_device(out, case, world)["served"][policy]
    total = 2 * SERVE_QUERIES
    assert want["queries"] == total and want["n_batches"] == 3
    sizes = [b[1] for b in want["batches"]]
    assert sizes == [SERVE_BATCH, SERVE_BATCH, total - 2 * SERVE_BATCH]
    for rank in range(world):
        got = out[rank]["mesh"][case]["served"][policy]
        assert same_bits(got["voted"], want["voted"])
        assert same_bits(got["fresh"], want["fresh"])
        assert (got["queries"], got["n_batches"]) == (want["queries"],
                                                      want["n_batches"])
        for g, w in zip(got["batches"], want["batches"]):
            assert g[:2] == w[:2]
            assert same_bits(g[2], w[2]) and same_bits(g[3], w[3])
    assert set(np.unique(want["voted"])) <= {-1.0, 1.0}


@pytest.mark.parametrize("case", range(len(SERVE_CASES)), ids=CASE_IDS)
def test_armed_streams_equal_the_one_device_run(ranks, case):
    world, out = ranks
    one = one_device(out, case, world)
    for rank in range(world):
        got = out[rank]["mesh"][case]
        assert got["streams"].keys() == one["streams"].keys()
        for name, want in one["streams"].items():
            assert got["streams"][name] == want, (rank, name)
        assert outcome(got["res"]) == outcome(one["res"])
    streams = one["streams"]
    assert len(streams["sent"]) == RUN["cycles"]
    assert len(streams["ef_residual_rms"]) == 2
    if SERVE_CASES[case]["wire"] == "int4_ef":
        assert min(streams["ef_residual_rms"]) > 0
    if SERVE_CASES[case].get("fault"):
        assert sum(streams["clipped"]) > 0 and sum(streams["corrupted"]) > 0


@pytest.mark.parametrize("case", range(len(SERVE_CASES)), ids=CASE_IDS)
def test_an_armed_hooked_run_equals_a_plain_run(ranks, case):
    world, out = ranks
    for rank in range(world):
        assert outcome(out[rank]["mesh"][case]["res"]) == outcome(
            out[rank]["plain"][case])


def test_an_axis_of_size_one_runs_the_one_device_path(ranks):
    world, out = ranks
    one = out[0]["size1"][1]
    for rank in range(world):
        got = out[rank]["size1"][0]
        assert got["places"] == [None, None]
        assert got["res"].compaction["shards"] == 1
        assert got["streams"] == one["streams"]
        assert outcome(got["res"]) == outcome(one["res"])
        for p in POLICIES:
            assert same_bits(got["served"][p]["voted"],
                             one["served"][p]["voted"])


def test_each_rank_tags_its_spans(ranks):
    world, out = ranks
    for rank in range(world):
        got = out[rank]["mesh"][0]
        assert got["span_ranks"] == [rank]
        assert got["report"].startswith(f"telemetry rank {rank}: ")
        assert "hist serve_batch_latency: n=3" in got["report"]
    assert out[0]["one"][0]["span_ranks"] == [None]


@functools.lru_cache(maxsize=None)
def jax_armed(case: int):
    """The JAX sharded engine on one device, armed, with JAX servers fed
    its snapshots (the codecs on its dense jnp path, the port's oracle in
    ``tests/test_torch_telemetry_ef.py``)."""
    X, y, Xt, yt = toy()
    tel = jtel.Telemetry()
    servers = {p: JServer(batch_size=SERVE_BATCH, policy=p, seed=3)
               for p in POLICIES}

    def hook(cycle, snap):
        for srv in servers.values():
            srv.serve_hook(cycle, snap)
            srv.submit(Xt[:SERVE_QUERIES])

    kw = ({} if SERVE_CASES[case]["wire"] is None
          else dict(compact_mode="dense", use_pallas=False))
    res = jax_run(JConfig(**engine_config(**SERVE_CASES[case])), X, y, Xt,
                  yt, engine="sharded", telemetry=tel, serve_hook=hook,
                  **RUN, **kw)
    for srv in servers.values():
        srv.flush()
    return tel, res, servers


@pytest.mark.parametrize("case", range(len(SERVE_CASES)), ids=CASE_IDS)
def test_streams_match_the_jax_sharded_engine(ranks, case):
    world, out = ranks
    tel, res, _ = jax_armed(case)
    for rank in range(world):
        got = out[rank]["mesh"][case]["streams"]
        for name in INT_STREAMS:
            assert got[name] == tel.streams[name], (rank, name)
        np.testing.assert_allclose(got["ef_residual_rms"],
                                   tel.streams["ef_residual_rms"],
                                   rtol=EF_RTOL, atol=0)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", range(len(SERVE_CASES)), ids=CASE_IDS)
def test_answers_match_the_jax_server(ranks, case, policy):
    """JAX's server fed the port's gathered snapshots answers bit for bit;
    fed the JAX engine's own snapshots, it assigns every query alike."""
    world, out = ranks
    X, y, Xt, yt = toy()
    got = out[0]["mesh"][case]
    port = JServer(batch_size=SERVE_BATCH, policy=policy, seed=3)
    for cyc in sorted(got["snaps"]):
        lanes = got["snaps"][cyc]
        port.serve_hook(cyc, JSnapshot(*(jnp.asarray(a) for a in lanes[:5]),
                                       jnp.int32(lanes[5])))
        port.submit(Xt[:SERVE_QUERIES])
    port.flush()
    _, _, servers = jax_armed(case)
    own = servers[policy]
    for rank in range(world):
        mine = out[rank]["mesh"][case]["served"][policy]
        assert same_bits(mine["voted"], np.asarray(port.answers()))
        assert same_bits(mine["fresh"], np.asarray(port.answers_fresh()))
        assert [(b.cycle, b.size) for b in own.batches] == [
            b[:2] for b in mine["batches"]]
        for b, m in zip(own.batches, mine["batches"]):
            assert np.array_equal(np.asarray(b.assign), m[2])
        for name in ("answers", "answers_fresh"):
            flips = np.mean(np.asarray(getattr(own, name)()) != (
                mine["voted"] if name == "answers" else mine["fresh"]))
            assert flips <= JAX_SNAPSHOT_FLIPS, (name, flips)
