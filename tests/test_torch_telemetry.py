"""Telemetry: the port against the JAX package.

The registry (``METRIC_STREAMS``, ``TRACKS`` and the span names the port
shares with the reference) must equal ``repro.core.telemetry``'s field by
field. Telemetry is a pure read: an armed run must equal the unarmed one
bit for bit on both port engines. Every integer stream of both port
engines must equal the JAX reference engine's bit for bit (clean, the
extreme scenario, and 10 % sign_flip with norm_clip), on the reference
test's configuration (``tests/test_telemetry.py``: n = 256, d = 8, 25
cycles, eval every 10, K = 2), and the two port engines must emit equal
streams. ``ef_residual_rms`` on the error-feedback codecs is held to the
JAX package in ``tests/test_torch_telemetry_ef.py``. The rest are the
reference's own telemetry tests, ported: the histogram, ``best_of``,
``maybe_span``, the tracks, the Chrome trace's schema (read by
``tools/trace_report.py``), several runs on one Telemetry, and
``GossipServer(telemetry=)``."""
import dataclasses
import json
import subprocess
import sys
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import pytest

from repro.configs.gossip_linear import GossipLinearConfig as JConfig
from repro.configs.gossip_linear import \
    with_failure_scenario as jax_with_scenario
from repro.core import telemetry as jtel
from repro.core.simulation import run_simulation as jax_run
from repro.data.synthetic import make_linear_dataset
from repro_torch.configs.gossip_linear import (GossipLinearConfig,
                                               with_failure_scenario)
from repro_torch.core import telemetry as ptel
from repro_torch.core.simulation import message_wire_bytes, run_simulation
from repro_torch.core.telemetry import (METRIC_STREAMS, SPAN_NAMES, TRACKS,
                                        LatencyHistogram, Telemetry, best_of,
                                        maybe_span)
from repro_torch.launch.gossip_serve import GossipServer

REPO = Path(__file__).resolve().parent.parent
ENGINES = ("reference", "sharded")
INT_STREAMS = [n for n, s in METRIC_STREAMS.items() if s.dtype == "int"]
KW = dict(cycles=25, eval_every=10, seed=0, k_rounds=2)
N_EVALS = 3                                   # cycles 10, 20, 25
# (scenario, config overrides) of the stream comparisons
CASES = {"clean": ("clean", {}),
         "extreme": ("extreme", {}),
         "sign_flip": ("extreme", dict(fault_model="sign_flip",
                                       byzantine_frac=0.1,
                                       defense="norm_clip"))}


def toy(n=256, d=8, seed=0):
    rng = np.random.default_rng(seed)
    X, y = make_linear_dataset(rng, n + 64, d, noise=0.05, separation=3.0)
    return X[:n], y[:n], X[n:], y[n:]


def base_cfg(**kw):
    base = dict(name="telemetry-toy", dim=8, n_nodes=256, n_test=64,
                class_ratio=(1, 1), lam=1e-3, variant="mu", cache_size=4)
    base.update(kw)
    return base


def port_cfg(scenario="clean", **kw):
    return with_failure_scenario(GossipLinearConfig(**base_cfg(**kw)),
                                 scenario)


def outcome(res):
    """Everything a run reports but the wall-clock."""
    return (res.cycles, res.err_fresh, res.err_voted, res.similarity,
            res.sent_total, res.delivered_total, res.lost_total,
            res.overflow_total, res.in_flight_total, res.wire_bytes_total,
            res.buf_payload_bytes, res.delivered_per_cycle, res.fault_stats,
            res.ef_residual_norm)


@pytest.fixture(scope="module")
def jax_streams():
    """The JAX reference engine's armed Telemetry for each of CASES, run
    once for the module."""
    X, y, Xt, yt = toy()
    out = {}
    for case, (scenario, kw) in CASES.items():
        tel = jtel.Telemetry()
        cfg = jax_with_scenario(JConfig(**base_cfg(**kw)), scenario)
        res = jax_run(cfg, X, y, Xt, yt, telemetry=tel, **KW)
        out[case] = tel, res
    return out


@pytest.fixture(scope="module")
def port_runs():
    """Armed runs of both port engines for each of CASES, made once:
    ``port_runs(engine, case) -> (telemetry, result)``."""
    X, y, Xt, yt = toy()
    cache = {}

    def get(engine, case):
        if (engine, case) not in cache:
            scenario, kw = CASES[case]
            tel = Telemetry(label=f"{engine}-{case}")
            res = run_simulation(port_cfg(scenario, **kw), X, y, Xt, yt,
                                 engine=engine, telemetry=tel, device="cpu",
                                 **KW)
            cache[engine, case] = tel, res
        return cache[engine, case]
    return get


# ---------------------------------------------------------------- registry


def test_registry_equals_the_reference():
    """The 13 streams field by field, the tracks, and every span name the
    reference has with its meaning; the port's own names each described
    in the module's docstring."""
    assert list(METRIC_STREAMS) == list(jtel.METRIC_STREAMS)
    for name, spec in METRIC_STREAMS.items():
        assert dataclasses.astuple(spec) == dataclasses.astuple(
            jtel.METRIC_STREAMS[name])
    assert TRACKS == jtel.TRACKS
    for name, meaning in jtel.SPAN_NAMES.items():
        assert SPAN_NAMES[name] == meaning
    own = set(SPAN_NAMES) - set(jtel.SPAN_NAMES)
    assert own == {"setup", "draw_enqueue", "draw_readback", "dense_table",
                   "pack_tables", "table_upload"}
    for name in own:
        assert f"``{name}``" in ptel.__doc__
        assert SPAN_NAMES[name].split(" — ")[0] in TRACKS


def test_emit_rejects_unregistered_stream():
    with pytest.raises(KeyError):
        Telemetry().emit("not_a_stream", 1)


def test_compile_count_reads_the_kernel_build(monkeypatch):
    """``compile_cache_sizes`` counts sources compiled and libraries
    loaded, read through ``sys.modules`` (0 when the build module was
    never imported), and a span records the difference."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "built", [])
    monkeypatch.setattr(_build, "_loaded", {})
    assert ptel.compile_cache_sizes() == 0
    tel = Telemetry()
    with tel.span("setup"):
        _build.built.append("gossip_cycle")
        _build._loaded["gossip_cycle"] = object()
    assert tel.spans[0].compiles == ptel.compile_cache_sizes() == 2
    monkeypatch.delitem(sys.modules, "repro_torch.kernels._build")
    assert ptel.compile_cache_sizes() == 0


# ------------------------------------------------------------ invisibility


@pytest.mark.parametrize("wire", [None, "int4"])
@pytest.mark.parametrize("scenario", ["clean", "extreme"])
@pytest.mark.parametrize("engine", ENGINES)
def test_armed_run_is_bitwise_invisible(engine, scenario, wire):
    """``telemetry=None`` against an armed Telemetry: curves, economy,
    fault counters, wire bytes and the EF norm equal bit for bit."""
    X, y, Xt, yt = toy()
    cfg = port_cfg(scenario, wire_dtype=wire)
    kw = dict(engine=engine, device="cpu", **KW)
    plain = run_simulation(cfg, X, y, Xt, yt, **kw)
    tel = Telemetry()
    armed = run_simulation(cfg, X, y, Xt, yt, telemetry=tel, **kw)
    assert outcome(plain) == outcome(armed)
    assert tel.stream_array("sent").size == KW["cycles"]


# ------------------------------------------------------- stream parity


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("engine", ENGINES)
def test_integer_streams_equal_the_jax_reference(engine, case, jax_streams,
                                                 port_runs):
    """Every integer stream equal to the JAX reference engine's, bit for
    bit, one value a cycle; the counters sum to the run's totals."""
    jt, jres = jax_streams[case]
    tel, res = port_runs(engine, case)
    for name in INT_STREAMS:
        got, want = tel.stream_array(name), jt.stream_array(name)
        assert got.size == KW["cycles"], name
        assert np.array_equal(got, want), (name, got, want)
    for name in ("corrupted", "gated", "clipped"):
        assert tel.stream_array(name).sum() == res.fault_stats[name] \
            == jres.fault_stats[name]
    assert tel.stream_array("ef_residual_rms").tolist() == [0.0] * N_EVALS
    if case == "sign_flip":
        assert tel.stream_array("corrupted").sum() > 0
        assert tel.stream_array("clipped").sum() > 0


@pytest.mark.parametrize("case", list(CASES))
def test_port_engines_emit_equal_streams(case, port_runs):
    ref, _ = port_runs("reference", case)
    sh, res = port_runs("sharded", case)
    for name in METRIC_STREAMS:
        assert np.array_equal(ref.stream_array(name),
                              sh.stream_array(name)), name
    assert ref.annotations["runs"][0]["engine"] == "reference"
    modes = sh.annotations["runs"][0]["chunk_modes"]
    assert modes == res.compaction["chunk_modes"]
    assert sum(modes.values()) == N_EVALS


@pytest.mark.parametrize("engine", ENGINES)
def test_message_economy_balance_from_streams(engine, port_runs):
    """Per cycle: cumsum(sent - delivered - lost - overflow) == in_flight,
    non-negative, ending at the undelivered remainder; wire_bytes == sent
    x per-message bytes; online_nodes from the churn trace."""
    tel, res = port_runs(engine, "extreme")
    sent = tel.stream_array("sent")
    flow = np.cumsum(sent - tel.stream_array("delivered")
                     - tel.stream_array("lost")
                     - tel.stream_array("overflow"))
    in_flight = tel.stream_array("in_flight")
    assert np.array_equal(flow, in_flight)
    assert (in_flight >= 0).all()
    assert sent.sum() == res.sent_total
    assert in_flight[-1] == res.in_flight_total == (
        res.sent_total - res.delivered_total - res.lost_total
        - res.overflow_total)
    assert np.array_equal(tel.stream_array("wire_bytes"),
                          sent * message_wire_bytes(8, None))
    assert np.array_equal(tel.stream_array("delivered"),
                          res.delivered_per_cycle)
    online = tel.stream_array("online_nodes")
    assert (online < 256).any() and (online > 0).all()


# --------------------------------------------------------------- histogram


def test_histogram_percentiles_exact_on_constant_samples():
    h = LatencyHistogram()
    for _ in range(100):
        h.record(0.004)
    assert h.count == 100
    assert h.p50 == h.p99 == h.p999 == 0.004
    assert h.mean == pytest.approx(0.004)


def test_histogram_percentiles_ordered_and_bounded():
    rng = np.random.default_rng(3)
    vals = rng.lognormal(-6.0, 1.5, 5000)
    h = LatencyHistogram()
    h.record_many(vals)
    assert h.min_value == vals.min() and h.max_value == vals.max()
    assert (h.min_value <= h.p50 <= h.p90 <= h.p99 <= h.p999
            <= h.max_value)
    exact = np.percentile(vals, 50)
    assert abs(h.p50 - exact) / exact < 0.4


def test_histogram_merge_is_exact_bucket_addition():
    rng = np.random.default_rng(4)
    a, b = LatencyHistogram(), LatencyHistogram()
    va, vb = rng.uniform(1e-5, 1e-2, 200), rng.uniform(1e-4, 1e-1, 300)
    a.record_many(va)
    b.record_many(vb)
    both = LatencyHistogram()
    both.record_many(np.concatenate([va, vb]))
    a.merge(b)
    assert np.array_equal(a.counts, both.counts)
    assert a.count == both.count == 500
    assert a.p99 == both.p99
    empty = LatencyHistogram()
    assert empty.p50 == 0.0 and empty.mean == 0.0


def test_best_of_returns_min_and_result():
    calls = []
    best, secs, result = best_of(lambda: calls.append(0) or len(calls),
                                 repeats=3)
    assert result == 3 and len(secs) == 3 and best == min(secs)


# ------------------------------------------------------------ spans, trace


def test_maybe_span_unarmed_is_noop():
    ctx = maybe_span(None, "route_chunk", track="control", chunk=0)
    assert isinstance(ctx, nullcontext)
    with ctx:
        pass
    tel = Telemetry()
    with maybe_span(tel, "route_chunk", track="control", chunk=0):
        pass
    assert [(s.name, s.track, s.args) for s in tel.spans] == [
        ("route_chunk", "control", {"chunk": 0})]


def test_span_track_validation():
    with pytest.raises(ValueError):
        Telemetry().span("cycle", track="not_a_track")


def test_sharded_spans_never_overlap():
    """The sharded driver's spans, on one track or across tracks, follow
    one another, so their shares of the spanned wall time are a split;
    every phase of the driver has its span (the table upload only on
    CUDA)."""
    X, y, Xt, yt = toy()
    tel = Telemetry()
    res = run_simulation(port_cfg("extreme", wire_dtype="int4_ef"), X, y, Xt,
                         yt, engine="sharded", telemetry=tel, device="cpu",
                         **KW)
    for track in TRACKS:
        spans = sorted((s for s in tel.spans if s.track == track),
                       key=lambda s: s.t0)
        for a, b in zip(spans, spans[1:]):
            assert a.t1 <= b.t0, (a, b)
    spans = sorted(tel.spans, key=lambda s: s.t0)
    for a, b in zip(spans, spans[1:]):
        assert a.t1 <= b.t0, (a, b)
    count = {}
    for s in tel.spans:
        count[s.name] = count.get(s.name, 0) + 1
    # on the CPU the packing is chosen per chunk (``pack_tables``) and the
    # dense table built only for the chunks that stay dense
    dense = res.compaction["chunk_modes"]["dense"]
    assert count == {"setup": 1, "draw_enqueue": N_EVALS,
                     "draw_readback": N_EVALS, "route_chunk": N_EVALS,
                     "pack_tables": N_EVALS, "chunk_dispatch": N_EVALS,
                     "eval": N_EVALS, "collect_results": 1,
                     **({"dense_table": dense} if dense else {})}
    assert sum(tel.phase_seconds().values()) <= tel.wall_seconds()


def test_chrome_trace_schema(tmp_path, port_runs):
    """An exported port trace is Chrome trace-event JSON in the
    reference's schema, and ``tools/trace_report.py`` summarizes it with
    every span name and the balance check."""
    tel, _ = port_runs("sharded", "extreme")
    fp = tel.export_chrome_trace(tmp_path / "trace.json")
    payload = json.loads(fp.read_text())
    events = payload["traceEvents"]
    assert payload["displayTimeUnit"] == "ms"
    thread_names = {e["args"]["name"] for e in events
                    if e["ph"] == "M" and e["name"] == "thread_name"}
    assert thread_names == set(TRACKS)
    spans = [e for e in events if e["ph"] == "X"]
    assert spans and len(spans) == len(tel.spans)
    for e in spans:
        assert e["name"] in SPAN_NAMES
        assert e["dur"] >= 0 and e["cat"] in TRACKS
        assert "compiles" in e["args"]
    counters = {e["name"] for e in events if e["ph"] == "C"}
    assert counters == {n for n, s in METRIC_STREAMS.items()
                        if s.cadence == "cycle"}
    other = payload["otherData"]
    assert set(other["streams"]) == set(METRIC_STREAMS)
    assert other["annotations"]["runs"][0]["engine"] == "sharded"

    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "trace_report.py"), str(fp)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert "balance invariant OK" in proc.stdout
    reported = {line.split()[0] for line in proc.stdout.splitlines()
                if line.startswith("  ") and "compiles=" in line}
    assert reported == {s.name for s in tel.spans}


def test_multi_run_arming_concatenates_streams():
    X, y, Xt, yt = toy()
    tel = Telemetry()
    for engine, scenario in (("sharded", "clean"), ("reference", "extreme")):
        run_simulation(port_cfg(scenario), X, y, Xt, yt, engine=engine,
                       telemetry=tel, device="cpu", **KW)
    assert tel.stream_array("sent").size == 2 * KW["cycles"]
    assert tel.stream_array("ef_residual_rms").size == 2 * N_EVALS
    assert [r["engine"] for r in tel.annotations["runs"]] == ["sharded",
                                                              "reference"]


# ----------------------------------------------------------------- serving


@pytest.mark.parametrize("engine", ENGINES)
def test_gossip_server_shares_its_histogram_and_spans(engine):
    """``GossipServer(telemetry=)`` on the protocol's Telemetry: the same
    answers as an unarmed server, its histogram shared as
    ``serve_batch_latency``, a ``snapshot_adopt`` span per eval point and
    a ``serve_batch`` span per batch on the serving track; every span
    name registered."""
    X, y, Xt, yt = toy()

    def serve(tel):
        srv = GossipServer(batch_size=16, telemetry=tel)

        def hook(cycle, snap):
            srv.serve_hook(cycle, snap)
            srv.submit(Xt[:20])

        res = run_simulation(port_cfg("extreme"), X, y, Xt, yt,
                             engine=engine, serve_hook=hook, telemetry=tel,
                             device="cpu", **KW)
        srv.flush()
        return srv, res

    plain, plain_res = serve(None)
    tel = Telemetry()
    srv, res = serve(tel)
    assert outcome(res) == outcome(plain_res)
    assert np.array_equal(srv.answers(), plain.answers())
    assert np.array_equal(srv.answers_fresh(), plain.answers_fresh())
    assert tel.histograms["serve_batch_latency"] is srv.hist
    assert srv.hist.count == len(srv.batches) == 4
    count = {}
    for s in tel.spans:
        count[s.name] = count.get(s.name, 0) + 1
        assert s.name in SPAN_NAMES
        if s.name in ("snapshot_adopt", "serve_batch", "snapshot"):
            assert s.track == "serving"
    assert count["snapshot_adopt"] == count["snapshot"] == N_EVALS
    assert count["serve_batch"] == len(srv.batches)
    assert "hist serve_batch_latency: n=4" in tel.phase_report()
