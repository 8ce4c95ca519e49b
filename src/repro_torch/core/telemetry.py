"""The serving tier's latency histogram.

Of ``repro/core/telemetry.py`` the port has so far only
:class:`LatencyHistogram`, the estimator behind ``GossipServer.stats()``;
the metric streams and span tracing are ROADMAP.md queue 1 item 7.
"""
from __future__ import annotations

import numpy as np


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
