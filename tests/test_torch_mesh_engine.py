"""The sharded engine's node mesh (``run_sharded_simulation(mesh=)``)
against the port's one-device run and the JAX package.

The mesh runs happen in spawned 2- and 4-rank ``gloo`` groups on the CPU
(``tests/torch_mesh_cases.py``, which imports no JAX; one group a size,
shared with ``test_torch_mesh_gossip.py`` and by the xdist workers), at ``tests/test_sharded_engine.py``'s mesh
setup: N = 128, d = 16, drop 0.3, delay <= 4, 20 cycles. On every
packing (dense, compact, compact_all) and wire (f32, int8_sr, int4_ef),
for Adaline, and under sign_flip + norm_clip, every rank's result is the
one-device run's bit for bit: curves, economy, fault counters, the EF
norm and every node's final lanes (``final_state``, gathered). Both
sides run with one thread (a case's one-device run on rank case % W).
d = 16 lies outside 5..8, the widths where a screen's sum order depends
on the row count a rank sums.
Against the JAX sharded engine on one device: the economy and the fault
counters exact, the curves within ``test_torch_engine.py``'s 0.02 (the
port's one-device bar; XLA fuses the step, the port runs it op by op).
The per-shard packers equal JAX's at 2 and 4 shards; the error is
pinned, and the hooks run under the mesh."""
import functools

import numpy as np
import pytest
import torch

from repro.configs.gossip_linear import GossipLinearConfig as JConfig
from repro.core import sharded_engine as jse
from repro.core.simulation import run_simulation as jax_run
from repro_torch.configs.gossip_linear import GossipLinearConfig
from repro_torch.core import sharded_engine as pse
from repro_torch.core.simulation import run_simulation
from repro_torch.launch import mesh as pmesh
from torch_mesh_cases import (ENGINE_CASES, RUN, N, engine_config,
                              shared_ranks, toy)

CURVE_TOL = 0.02        # tests/test_torch_engine.py's bar, unchanged
WORLDS = [2, 4]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"W{w}")
def ranks(request, tmp_path_factory):
    out = shared_ranks(tmp_path_factory, request.param)
    return request.param, [r["engine"] for r in out]


def bitwise(a, b):
    assert a.cycles == b.cycles
    assert (a.err_fresh, a.err_voted, a.similarity) == (
        b.err_fresh, b.err_voted, b.similarity)
    assert (a.sent_total, a.delivered_total, a.lost_total, a.overflow_total,
            a.in_flight_total, a.delivered_per_cycle, a.wire_bytes_total,
            a.buf_payload_bytes) == (
        b.sent_total, b.delivered_total, b.lost_total, b.overflow_total,
        b.in_flight_total, b.delivered_per_cycle, b.wire_bytes_total,
        b.buf_payload_bytes)
    assert a.fault_stats == b.fault_stats
    assert a.ef_residual_norm == b.ef_residual_norm


@pytest.mark.parametrize("case", range(len(ENGINE_CASES)),
                         ids=lambda i: "-".join(
                             str(v) for v in ENGINE_CASES[i].values()))
def test_every_rank_is_the_one_device_run_bit_for_bit(ranks, case):
    world, out = ranks
    one = out[case % world]["one"][case]
    for rank in range(world):
        got = out[rank]["runs"][case]
        bitwise(got, one)
        assert got.compaction["shards"] == world
        mode = ENGINE_CASES[case]["mode"]
        if mode is not None:
            assert got.compaction["chunk_modes"][mode] == len(got.cycles)
        assert got.final_state.keys() == one.final_state.keys()
        for k, v in one.final_state.items():
            g = got.final_state[k]
            assert g.dtype == v.dtype and g.shape == v.shape
            assert torch.equal(g.view(torch.uint8) if g.is_floating_point()
                               else g, v.view(torch.uint8)
                               if v.is_floating_point() else v), k
    if ENGINE_CASES[case].get("fault"):
        assert one.fault_stats["corrupted"] > 0
        assert one.fault_stats["clipped"] > 0


JAX_CASES = [i for i, c in enumerate(ENGINE_CASES) if c["mode"] is None
             or (c["mode"] == "dense" and c["wire"] is None)]


@functools.lru_cache(maxsize=None)
def jax_sharded(case: int):
    """JAX's sharded engine on one device for ``ENGINE_CASES[case]`` (one
    run a case, shared by both group sizes)."""
    X, y, Xt, yt = toy()
    return jax_run(JConfig(**engine_config(**ENGINE_CASES[case])), X, y, Xt,
                   yt, engine="sharded", **RUN)


@pytest.mark.parametrize("case", JAX_CASES,
                         ids=lambda i: "-".join(
                             str(v) for v in ENGINE_CASES[i].values()))
def test_mesh_runs_match_the_jax_sharded_engine(ranks, case):
    """Economy and fault counters exact, curves within CURVE_TOL."""
    world, out = ranks
    j = jax_sharded(case)
    for rank in range(world):
        got = out[rank]["runs"][case]
        assert (got.sent_total, got.delivered_total, got.lost_total,
                got.overflow_total, got.delivered_per_cycle) == (
            j.sent_total, j.delivered_total, j.lost_total, j.overflow_total,
            j.delivered_per_cycle)
        assert got.fault_stats == j.fault_stats
        diff = max(abs(a - b) for a, b in zip(got.err_fresh + got.err_voted,
                                              j.err_fresh + j.err_voted))
        assert diff <= CURVE_TOL, diff


def test_an_axis_of_size_one_runs_the_one_device_path(ranks):
    world, out = ranks
    one = out[0]["size1"][1]
    for rank in range(world):
        got = out[rank]["size1"][0]
        assert got.compaction == one.compaction
        assert got.compaction["shards"] == 1
        bitwise(got, one)


def test_mesh_errors_are_pinned(ranks):
    """N not divisible by the node axis raises; ``serve_hook`` and
    ``telemetry`` under a node mesh run (their results are held to the
    one-device run in ``test_torch_mesh_serving.py``): the hook gets this
    rank's shard at the one eval point, the streams every cycle."""
    world, out = ranks
    for rank in range(world):
        err = out[rank]["errors"]
        kind, msg = err["indivisible"]
        assert kind == "ValueError"
        assert msg == ("sharded engine needs N divisible by the 'nodes' "
                       f"mesh axis ({129} % {world} != 0)")
        assert err["serve_hook"] is None and err["telemetry"] is None
        hooked = out[rank]["hooked"]
        nl = N // world
        ((cycle, shape, place),) = hooked["serve_hook"]
        assert cycle == 2 and shape[0] == nl
        assert place == (rank * nl, (rank + 1) * nl, rank, world, N)
        assert hooked["telemetry"]["sent"] == 2
        assert hooked["telemetry"]["ef_residual_rms"] == 1
        assert hooked["rank"] == rank


@pytest.mark.parametrize("shards", [2, 4])
def test_per_shard_packers_equal_jax(shards):
    """shard_list_width, _pack_index_lists, _packed_columns and both
    packers on random per-cycle lists with ``shards`` node shards."""
    rng = np.random.default_rng(shards)
    n, T, K = 64, 5, 3
    for trial in range(4):
        lists = [np.sort(rng.choice(n, size=rng.integers(0, n // 2),
                                    replace=False)).astype(np.int32)
                 for _ in range(T)]
        lists[trial % T] = np.empty(0, np.int32)
        w = pse.shard_list_width(lists, n, shards)
        assert w == jse.shard_list_width(lists, n, shards)
        assert np.array_equal(pse._pack_index_lists(lists, n, w + 1, shards),
                              jse._pack_index_lists(lists, n, w + 1, shards))
        # winners nested in the lists: round r for the first ids of a list
        t_w, r_w, dst_w = [], [], []
        for t, r in enumerate(lists):
            for j, node in enumerate(r):
                for k in range(1 + j % K):
                    t_w.append(t)
                    r_w.append(k)
                    dst_w.append(node)
        t_w, r_w, dst_w = (np.asarray(a, np.int32) for a in (t_w, r_w,
                                                             dst_w))
        order = np.lexsort((r_w, dst_w, t_w))
        t_w, r_w, dst_w = t_w[order], r_w[order], dst_w[order]
        slot_w = rng.integers(0, 4 * n, size=t_w.size).astype(np.int32)
        win = (t_w, r_w, dst_w, slot_w)
        assert np.array_equal(
            pse._packed_columns(lists, t_w, dst_w, n, w, shards),
            jse._packed_columns(lists, t_w, dst_w, n, w, shards))
        for a, b in zip(pse.pack_compact_all(win, lists, T, K, n, w, shards),
                        jse.pack_compact_all(win, lists, T, K, n, w,
                                             shards)):
            assert np.array_equal(a, b)
        mk = r_w > 0
        multi = [np.unique(dst_w[mk & (t_w == t)]).astype(np.int32)
                 for t in range(T)]
        wm = max(pse.shard_list_width(multi, n, shards), 1)
        for a, b in zip(
                pse.pack_compact_rounds(win, multi, T, K, n, wm, shards),
                jse.pack_compact_rounds(win, multi, T, K, n, wm, shards)):
            assert np.array_equal(a, b)


def test_retrace_counts_equal_the_reference():
    """The distinct chunk and draw signatures of one run, per label,
    against the reference's compile-cache entries for the same config
    (a lam and drop no other test uses, so every label is new)."""
    n = 96
    base = dict(engine_config(n=n), lam=1.234e-3, drop_prob=0.37)
    X, y, Xt, yt = toy(n)
    kw = dict(cycles=25, eval_every=10, seed=2, engine="sharded")
    jlabels = set(jse._CHUNK_FNS)
    jdraw = jse._draw_chunk._cache_size()
    jax_run(JConfig(**base), X, y, Xt, yt, **kw)
    want = {label.split(":", 1)[1]: fn._cache_size()
            for label, fn in jse._CHUNK_FNS.items() if label not in jlabels}
    plabels = set(pse._CHUNK_SIGS)
    pdraw = len(pse._DRAW_SIGS)
    run_simulation(GossipLinearConfig(**base), X, y, Xt, yt, device="cpu",
                   **kw)
    counts = pse.retrace_counts()
    got = {label.split(":", 1)[1]: len(sigs)
           for label, sigs in pse._CHUNK_SIGS.items()
           if label not in plabels}
    assert got == want and sum(got.values()) >= 2
    assert (counts["sharded_engine._draw_chunk"] - pdraw
            == jse._draw_chunk._cache_size() - jdraw == 2)
    for label, sigs in pse._CHUNK_SIGS.items():
        assert counts[f"sharded_engine.chunk_fn[{label}]"] == len(sigs)


def test_smoke_mesh_is_one_by_one_and_runs_the_one_device_path(
        tmp_path_factory):
    ((sizes, chips, got, one),) = shared_ranks(tmp_path_factory, 1)
    assert sizes == {"data": 1, "model": 1} and chips == 1
    assert got.compaction == one.compaction
    bitwise(got, one)


def test_mesh_builders_read_the_mesh():
    class FakeMesh:             # the two attributes the readers use
        mesh_dim_names = ("pod", "data", "model")
        mesh = torch.arange(8).reshape(2, 2, 2)
    assert pmesh.mesh_axis_sizes(FakeMesh) == {"pod": 2, "data": 2,
                                               "model": 2}
    assert pmesh.num_chips(FakeMesh) == 8
    assert pmesh.rank_backend(2, "cpu") == "gloo"


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
@pytest.mark.parametrize("entry", ["make_mesh", "make_smoke_mesh",
                                   "init_rank", "run_ranks"])
def test_mesh_entry_points_default_to_the_card(entry):
    """Without ``device_type`` the ranks run on the card, and without one
    they raise before any process group or rank is started."""
    call = {"make_mesh": lambda: pmesh.make_mesh((1,), ("data",)),
            "make_smoke_mesh": pmesh.make_smoke_mesh,
            "init_rank": lambda: pmesh.init_rank(0, 1, "file:///nowhere"),
            "run_ranks": lambda: pmesh.run_ranks(print, 2)}[entry]
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        call()


@pytest.mark.parametrize("rows", [0, 1, 5])
def test_row_packing_round_trips_every_lane(rows):
    """``compat.pack_rows``/``unpack_rows`` on the exchange's lanes (int8
    codes of an odd width, the int32 counter, the f16 scale and
    zero-point, f32 models): every bit back, also for one row, whose
    lanes start at offsets their element sizes do not divide."""
    from repro_torch.sharding import compat
    rng = np.random.default_rng(rows)
    lanes = [torch.from_numpy(rng.integers(-128, 128, (rows, 10))
                              .astype(np.int8)),
             torch.from_numpy(rng.integers(0, 99, rows).astype(np.int32)),
             torch.from_numpy(rng.standard_normal(rows).astype(np.float16)),
             torch.from_numpy(rng.standard_normal(rows).astype(np.float16)),
             torch.from_numpy(rng.standard_normal((rows, 3, 5))
                              .astype(np.float32))]
    buf = compat.pack_rows(lanes)
    assert buf.dtype == torch.uint8 and buf.shape == (rows, 10 + 4 + 2 + 2
                                                      + 60)
    for got, want in zip(compat.unpack_rows(buf, lanes), lanes):
        assert got.dtype == want.dtype and torch.equal(got, want)
