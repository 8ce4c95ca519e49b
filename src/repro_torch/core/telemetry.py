"""Protocol telemetry: metric streams, host spans, latency histograms.

Counterpart of ``repro/core/telemetry.py``, with its three faces:

* **Per-cycle metric streams**: ``METRIC_STREAMS`` registers the series
  both engines emit when a run is armed: the message economy (with
  ``in_flight`` as the running balance sent - delivered - lost -
  overflow), wire bytes, receiver occupancy, fault counters, the EF
  residual RMS and the online count. The registry equals the reference's
  field by field, and every integer stream of both port engines equals
  the JAX reference engine's bit for bit (``tests/test_torch_telemetry.py``).
* **Host spans**: ``telemetry.span("route_chunk", track="control")``
  times one phase of the driver with ``time.perf_counter`` and records
  the kernel libraries built or loaded meanwhile (:func:`compile_cache_sizes`),
  exported as Chrome trace-event JSON (:meth:`Telemetry.export_chrome_trace`)
  in the reference's schema, so ``tools/trace_report.py`` reads a port
  trace unchanged.
* **Latency histograms**: :class:`LatencyHistogram`, the estimator behind
  ``GossipServer.stats()``, shared into the trace as
  ``serve_batch_latency`` by ``GossipServer(telemetry=)``.

The names the port shares with the reference keep its meaning. The
sharded driver has phases the reference lacks, and ``SPAN_NAMES`` names
them too: it draws one chunk ahead on the device (``draw_enqueue``) and
reads the tables back before routing (``draw_readback``, where the host
waits for the card), instead of staging every chunk's draws up front
(the reference's ``stage_draws``, which the port never emits); it builds
the dense table (``dense_table``), or picks the chunk's packing and packs
its compact tables (``pack_tables``, where compacting is on), and uploads
them through pinned memory (``table_upload``) outside ``route_chunk``,
which times the numpy router alone; and ``setup`` times everything before
cycle 0. The sharded
engine's spans never nest (the server's ``snapshot_adopt`` and
``serve_batch`` run inside the engine's ``snapshot`` when a server is
hooked in), so :meth:`Telemetry.phase_report`'s shares of the spanned
wall time read as a split of the host's time.

The contract is the reference's: **telemetry is a pure read**.
``telemetry=None`` (the default everywhere) runs the unarmed engines, with
no added launch, synchronisation or host reduction, and an armed run
leaves curves, economy, fault counters, wire bytes and the EF norm bit
for bit equal. Telemetry draws no random numbers: spans use the host
clock and streams are integer and float reads of what the engines
compute.
"""
from __future__ import annotations

import json
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# metric-stream registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MetricStream:
    """Schema entry for one registered per-run metric series.

    ``cadence`` is "cycle" (one value per gossip cycle) or "eval" (one
    value per eval point). ``parity`` marks the stream as part of the
    cross-engine parity surface: both engines emit it equal at a matched
    seed (integers exactly)."""
    name: str
    cadence: str            # "cycle" | "eval"
    dtype: str              # "int" | "float"
    parity: bool
    description: str


def _stream(name, cadence, dtype, parity, description):
    return name, MetricStream(name, cadence, dtype, parity, description)


# The registered schema, the reference's: every stream is emitted by both
# engines when a run is armed.
METRIC_STREAMS: Dict[str, MetricStream] = dict([
    _stream("sent", "cycle", "int", True,
            "messages entering the network this cycle (send_ok senders)"),
    _stream("delivered", "cycle", "int", True,
            "messages accepted by an online node within the K rounds"),
    _stream("lost", "cycle", "int", True,
            "messages due this cycle whose destination was offline"),
    _stream("overflow", "cycle", "int", True,
            "arrivals beyond the K winner rounds (truncated receives)"),
    _stream("in_flight", "cycle", "int", True,
            "messages still in the delay buffer after this cycle "
            "(cumulative sent - delivered - lost - overflow; the PR 1 "
            "balance invariant, continuously emitted)"),
    _stream("wire_bytes", "cycle", "int", True,
            "bytes put on the wire this cycle (sent x per-message bytes "
            "of the run's wire codec)"),
    _stream("recv_nodes", "cycle", "int", True,
            "nodes receiving at least one message (round-1 winners; the "
            "numerator of the router's compaction occupancy)"),
    _stream("multi_nodes", "cycle", "int", True,
            "nodes receiving in round 2 or later (the compact packing's "
            "subset)"),
    _stream("online_nodes", "cycle", "int", True,
            "nodes online this cycle (the churn trace row sum)"),
    _stream("corrupted", "cycle", "int", True,
            "Byzantine sends this cycle (fault model armed and send_ok)"),
    _stream("gated", "cycle", "int", True,
            "receives rejected by the defense screen this cycle"),
    _stream("clipped", "cycle", "int", True,
            "receives rescaled by norm_clip this cycle"),
    _stream("ef_residual_rms", "eval", "float", True,
            "RMS per-node L2 norm of the error-feedback residual at each "
            "eval point (0.0 for codecs without EF state)"),
])


# ---------------------------------------------------------------------------
# host spans
# ---------------------------------------------------------------------------

# span tracks become named Perfetto threads; the index is the trace tid
TRACKS: Tuple[str, ...] = ("host", "control", "device", "serving", "eval")

# span names: snake_case verbs naming the phase, stable across PRs so that
# trace diffs stay meaningful. The first nine are the reference's; the
# port's driver emits every one of them but ``stage_draws``.
SPAN_NAMES = {
    "route_chunk":    "control — host winner routing for one chunk",
    "stage_draws":    "control — upfront device draws for all chunks",
    "chunk_dispatch": "device — dispatch one data-plane scan chunk",
    "cycle":          "device — one reference-engine cycle (dispatch+sync)",
    "eval":           "eval — population error at an eval point",
    "collect_results": "device — drain deferred eval results (sync point)",
    "snapshot":       "serving — snapshot build + serve_hook call",
    "snapshot_adopt": "serving — GossipServer adopts a snapshot (sync)",
    "serve_batch":    "serving — assemble + answer one query batch",
    # the port's own phases of the sharded driver
    "setup":          "host — churn trace, data upload, carry and key "
                      "schedule before cycle 0",
    "draw_enqueue":   "control — enqueue one chunk's threefry draws on "
                      "the device",
    "draw_readback":  "device — read one chunk's draw tables back to the "
                      "host (waits for the card)",
    "dense_table":    "control — build one chunk's dense (T, K, N) routing "
                      "table",
    "pack_tables":    "control — pick one chunk's packing from its receiver "
                      "counts and pack its compact tables",
    "table_upload":   "control — pin one chunk's routing table and queue "
                      "its upload",
}


def compile_cache_sizes() -> int:
    """Kernel libraries built or loaded so far in this process.

    The port has no jit caches: the work that makes a first span slow is
    a CUDA source compiled by ``nvcc`` (``kernels._build.build``) or a
    library loaded at first use (``kernels._build.load``, reached through
    the kernels' ``functools.lru_cache`` loaders). On the card this counts
    each source compiled plus each library loaded, so a span's "compiles"
    is the number of those that happened inside it; on the CPU it stays 0,
    since the plain versions load nothing. Read through ``sys.modules``,
    so telemetry never forces an import."""
    build = sys.modules.get("repro_torch.kernels._build")
    if build is None:
        return 0
    return len(build.built) + len(build._loaded)


@dataclass
class Span:
    """One finished host span (relative perf_counter seconds)."""
    name: str
    track: str
    t0: float
    t1: float
    compiles: int
    args: Dict[str, object]

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class _SpanCtx:
    __slots__ = ("tel", "name", "track", "args", "_t0", "_c0")

    def __init__(self, tel: "Telemetry", name: str, track: str, args):
        self.tel, self.name, self.track, self.args = tel, name, track, args

    def __enter__(self):
        self._c0 = compile_cache_sizes()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.tel.spans.append(Span(
            self.name, self.track, self._t0 - self.tel._origin,
            t1 - self.tel._origin, compile_cache_sizes() - self._c0,
            self.args))
        return False


def maybe_span(tel: Optional["Telemetry"], name: str, track: str = "host",
               **args):
    """``tel.span(...)`` when armed, a free ``nullcontext`` when not: the
    one-liner the engines use so the unarmed path stays as it was."""
    if tel is None:
        return nullcontext()
    return tel.span(name, track=track, **args)


# ---------------------------------------------------------------------------
# latency histogram
# ---------------------------------------------------------------------------


class LatencyHistogram:
    """Fixed-bucket log-scale latency histogram (seconds).

    64 buckets, 8 per decade from 1 microsecond to 100 seconds, plus an
    underflow and an overflow bucket: the reference's 65 edges, so
    histograms from both packages merge bucket-wise. Percentiles
    interpolate linearly inside the owning bucket and are clamped to the
    observed [min, max], so single-sample and constant-sample histograms
    report exact values."""

    EDGES = np.logspace(-6.0, 2.0, 8 * 8 + 1)     # 65 edges, 64 buckets

    def __init__(self):
        self.counts = np.zeros(self.EDGES.size + 1, np.int64)
        self.count = 0
        self.total = 0.0
        self.min_value = float("inf")
        self.max_value = 0.0

    def record(self, seconds: float) -> None:
        self.record_many([seconds])

    def record_many(self, seconds) -> None:
        v = np.asarray(seconds, np.float64).ravel()
        if v.size == 0:
            return
        idx = np.searchsorted(self.EDGES, v, side="right")
        np.add.at(self.counts, idx, 1)
        self.count += int(v.size)
        self.total += float(v.sum())
        self.min_value = min(self.min_value, float(v.min()))
        self.max_value = max(self.max_value, float(v.max()))

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        self.counts += other.counts
        self.count += other.count
        self.total += other.total
        self.min_value = min(self.min_value, other.min_value)
        self.max_value = max(self.max_value, other.max_value)
        return self

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """q in [0, 100] -> seconds (0.0 on an empty histogram)."""
        if self.count == 0:
            return 0.0
        target = q / 100.0 * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.EDGES[i - 1] if i > 0 else self.min_value
                hi = (self.EDGES[i] if i < self.EDGES.size
                      else self.max_value)
                frac = (target - cum) / c
                v = lo + frac * (hi - lo)
                return float(min(max(v, self.min_value), self.max_value))
            cum += c
        return self.max_value

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p90(self) -> float:
        return self.percentile(90.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    @property
    def p999(self) -> float:
        return self.percentile(99.9)

    def to_dict(self) -> dict:
        """JSON-ready dump of the occupied buckets (``bucket_le``: each
        bucket's upper edge)."""
        nz = np.nonzero(self.counts)[0]
        return dict(
            count=self.count,
            mean_s=self.mean,
            min_s=self.min_value if self.count else 0.0,
            max_s=self.max_value,
            p50_s=self.p50, p90_s=self.p90, p99_s=self.p99,
            p999_s=self.p999,
            bucket_le=[(float(self.EDGES[i]) if i < self.EDGES.size
                        else float("inf")) for i in nz],
            bucket_counts=[int(self.counts[i]) for i in nz],
        )


# ---------------------------------------------------------------------------
# wall-clock helpers
# ---------------------------------------------------------------------------


class Timer:
    """Context-manager wall clock; ``.s`` holds elapsed seconds
    (perf_counter, monotonic). Work queued on the card is not waited for:
    end the timed block with ``torch.cuda.synchronize()`` to time it."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.s = time.perf_counter() - self.t0
        return False


def best_of(fn, repeats: int = 2):
    """Min-time estimator: call ``fn()`` ``repeats`` times.

    Returns ``(best_seconds, all_seconds, last_result)``. Noise from
    neighbours is additive, so the minimum is the estimator."""
    secs: List[float] = []
    result = None
    for _ in range(max(repeats, 1)):
        with Timer() as t:
            result = fn()
        secs.append(t.s)
    return min(secs), secs, result


# ---------------------------------------------------------------------------
# the Telemetry object
# ---------------------------------------------------------------------------


class Telemetry:
    """Armed observability for one (or several back-to-back) runs.

    Pass as ``run_simulation(..., telemetry=tel)`` (either engine) and/or
    ``GossipServer(telemetry=tel)``. Collects the registered metric
    streams, host spans and latency histograms; export with
    :meth:`export_chrome_trace`, summarize with :meth:`phase_report` or
    ``tools/trace_report.py`` on the exported file.

    One Telemetry may be armed across several sequential runs: spans
    share one wall-clock origin and stream segments concatenate in run
    order (each run's ``in_flight`` balance restarts from zero at its own
    first cycle).

    Under a node mesh each rank arms its own Telemetry; the sharded
    engine sets ``rank`` (the process's global rank), which tags every
    later span (``args["rank"]``), the report's header and the trace's
    host process name, so each rank's split of its host time reads on
    its own."""

    def __init__(self, label: str = ""):
        self.label = label
        self.rank: Optional[int] = None
        self.streams: Dict[str, List] = {n: [] for n in METRIC_STREAMS}
        self.spans: List[Span] = []
        self.histograms: Dict[str, LatencyHistogram] = {}
        self.annotations: Dict[str, object] = {}
        self._origin = time.perf_counter()

    # ------------------------------------------------------------- streams
    def emit(self, name: str, values) -> None:
        """Append value(s) to a registered stream (scalar or sequence)."""
        if name not in METRIC_STREAMS:
            raise KeyError(f"unregistered metric stream {name!r} "
                           f"(registered: {sorted(METRIC_STREAMS)})")
        kind = METRIC_STREAMS[name].dtype
        cast = float if kind == "float" else int
        if np.ndim(values) == 0:
            self.streams[name].append(cast(values))
        else:
            self.streams[name].extend(cast(v) for v in values)

    def emit_row(self, **values) -> None:
        """Emit one value (or one chunk's values) into several streams."""
        for name, v in values.items():
            self.emit(name, v)

    def stream_array(self, name: str) -> np.ndarray:
        kind = METRIC_STREAMS[name].dtype
        return np.asarray(self.streams[name],
                          np.float64 if kind == "float" else np.int64)

    # --------------------------------------------------------------- spans
    def span(self, name: str, track: str = "host", **args) -> _SpanCtx:
        if track not in TRACKS:
            raise ValueError(f"unknown span track {track!r} "
                             f"(expected one of {TRACKS})")
        if self.rank is not None:
            args = {"rank": self.rank, **args}
        return _SpanCtx(self, name, track, args)

    def histogram(self, name: str) -> LatencyHistogram:
        return self.histograms.setdefault(name, LatencyHistogram())

    # ------------------------------------------------------------ reports
    def phase_seconds(self) -> Dict[str, float]:
        """Total span seconds per span name (the per-phase summary)."""
        out: Dict[str, float] = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + s.seconds
        return out

    def compile_total(self) -> int:
        return sum(s.compiles for s in self.spans)

    def wall_seconds(self) -> float:
        if not self.spans:
            return 0.0
        return (max(s.t1 for s in self.spans)
                - min(s.t0 for s in self.spans))

    def phase_report(self) -> str:
        """Printable per-phase table (what the ``--trace`` examples print;
        ``tools/trace_report.py`` prints the same from an exported file).
        "compiles" counts kernel libraries built or loaded
        (:func:`compile_cache_sizes`)."""
        wall = self.wall_seconds()
        who = "" if self.rank is None else f" rank {self.rank}"
        lines = [f"telemetry{who}: {len(self.spans)} spans, "
                 f"{self.compile_total()} kernel builds and loads, "
                 f"{wall:.3f}s spanned wall clock"]
        counts: Dict[str, int] = {}
        compiles: Dict[str, int] = {}
        for s in self.spans:
            counts[s.name] = counts.get(s.name, 0) + 1
            compiles[s.name] = compiles.get(s.name, 0) + s.compiles
        for name, secs in sorted(self.phase_seconds().items(),
                                 key=lambda kv: -kv[1]):
            pct = 100.0 * secs / wall if wall > 0 else 0.0
            lines.append(f"  {name:<16} {secs:>9.3f}s {pct:>5.1f}%  "
                         f"x{counts[name]:<5d} compiles={compiles[name]}")
        sent = self.stream_array("sent")
        wb = self.stream_array("wire_bytes")
        if sent.size:
            lines.append(f"  streams: {sent.size} cycles, "
                         f"{sent.mean():,.0f} msgs/cycle sent, "
                         f"{wb.mean():,.0f} wire B/cycle")
        for name, h in sorted(self.histograms.items()):
            if h.count:
                lines.append(
                    f"  hist {name}: n={h.count} p50={h.p50 * 1e3:.3f}ms "
                    f"p99={h.p99 * 1e3:.3f}ms p999={h.p999 * 1e3:.3f}ms")
        return "\n".join(lines)

    # ------------------------------------------------------- chrome export
    def export_chrome_trace(self, path) -> Path:
        """Write Chrome trace-event JSON (the ``chrome://tracing`` /
        Perfetto "JSON" flavor) in the reference's schema: one complete
        ("X") event per span on a named thread per track, an instant event
        per span that built or loaded kernel libraries, and the per-cycle
        metric streams as counter ("C") events on a synthetic pid=1
        timeline where 1 cycle == 1 microsecond (protocol time, not wall
        time). Streams, histograms and annotations ride in ``otherData``,
        so ``tools/trace_report.py`` rebuilds the summary from the file
        alone."""
        events: List[dict] = [
            {"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
             "args": {"name": "gossip host"
                      + (f" {self.label}" if self.label else "")
                      + ("" if self.rank is None else f" rank {self.rank}")}},
            {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": "protocol streams (1 cycle = 1 us)"}},
        ]
        for tid, track in enumerate(TRACKS):
            events.append({"ph": "M", "pid": 0, "tid": tid,
                           "name": "thread_name", "args": {"name": track}})
        for s in self.spans:
            tid = TRACKS.index(s.track)
            args = {k: (v if isinstance(v, (int, float, str, bool))
                        else str(v)) for k, v in s.args.items()}
            args["compiles"] = s.compiles
            events.append({"ph": "X", "pid": 0, "tid": tid, "name": s.name,
                           "ts": s.t0 * 1e6, "dur": s.seconds * 1e6,
                           "args": args, "cat": s.track})
            if s.compiles:
                events.append({"ph": "i", "pid": 0, "tid": tid,
                               "name": f"kernel build/load x{s.compiles}",
                               "ts": s.t0 * 1e6, "s": "t",
                               "cat": "compile"})
        for name, spec in METRIC_STREAMS.items():
            if spec.cadence != "cycle":
                continue
            for c, v in enumerate(self.streams[name]):
                events.append({"ph": "C", "pid": 1, "tid": 0, "name": name,
                               "ts": float(c), "args": {name: v}})
        payload = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "label": self.label,
                "annotations": self.annotations,
                "streams": {n: self.streams[n] for n in METRIC_STREAMS},
                "histograms": {n: h.to_dict()
                               for n, h in self.histograms.items()},
                "compile_total": self.compile_total(),
            },
        }
        fp = Path(path)
        fp.write_text(json.dumps(payload) + "\n")
        return fp
