#!/usr/bin/env python
"""Compare ``chip_smoke.py --out`` results of several runs, typically a
parent tree and a change run in turns on one card (parent, change, change,
parent).

Usage:

    python tools/compare_chip_runs.py parent1.json change1.json \
        change2.json parent2.json

Prints, for each run, the per-launch times of every kernel row of the
``kernels`` line, of the receive kernel in phases 3-5 and the bf16/f16
and cosine_gate timings of phase 1, and of the send kernels in phase 4
(with the strided route's on the same inputs); then checks that every
non-timing value of phases 2-6, 10 and 11 (economy, curves, wire and
buffer bytes, EF residual, fault counters, launches, served queries and
accuracy, the LM paths' token and logit agreement, phase 10's expert
flips) is equal across all runs, and exits 1
listing any that differ. Needs only the standard library: it runs
anywhere."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

# result keys whose values must not move between runs of the same seeds
EXACT = {"sent", "delivered", "lost", "overflow", "in_flight", "err_fresh",
         "err_voted", "wire_bytes_total", "buf_payload_bytes",
         "ef_residual_norm", "fault_stats", "curve_diff", "launches",
         "send_launches", "voted_launches", "queries", "batches",
         "voted_accuracy", "logit_diff", "first_token_share", "token_share",
         "small_check_diff", "largest_logit", "expert_flips",
         "pinned_logit_diff", "small"}
PHASES = ("phase2", "phase3", "phase4", "phase5", "phase6", "phase10",
          "phase11")


def exact_values(node, path=""):
    """(path, value) of every EXACT key under ``node``."""
    if isinstance(node, dict):
        for key, val in node.items():
            sub = f"{path}.{key}" if path else key
            if key in EXACT:
                yield sub, val
            elif key not in ("profile", "flash"):
                yield from exact_values(val, sub)


def receive_times(res):
    """The receive kernel's ms per launch in phases 3-5 and phase 1."""
    out = {"phase3 f32": res["phase3"]["kernel_ms"]}
    for wire, row in res.get("phase4", {}).items():
        out[f"phase4 {wire}"] = row["receive"]["ms"]
    out["phase5 norm_clip"] = res["phase5"]["receive"]["ms"]
    for mode, row in res.get("decode_modes", {}).items():
        out[f"phase1 {mode}"] = row["ms"]
    return out


def send_times(res):
    """The send kernel's ms per launch in phase 4 on the route taken, and
    the strided route's on the same inputs where the run timed it."""
    out = {}
    for wire, row in res.get("phase4", {}).items():
        out[f"phase4 {wire}"] = row["send"]["ms"]
        if "strided_ms" in row["send"]:
            out[f"phase4 {wire} strided"] = row["send"]["strided_ms"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="+", type=Path,
                    help="chip_smoke.py --out JSON files, in run order")
    args = ap.parse_args(argv)
    runs = [json.loads(p.read_text()) for p in args.runs]
    names = [p.stem for p in args.runs]
    print("card:", "; ".join(sorted({r.get("card", "?") for r in runs})))
    rows = {}
    for name, res in zip(names, runs):
        for k in res.get("kernels", []):
            rows.setdefault(f"kernels {k['name']}", {})[name] = k["ms"]
        for label, ms in receive_times(res).items():
            rows.setdefault(f"receive {label}", {})[name] = ms
        for label, ms in send_times(res).items():
            rows.setdefault(f"send {label}", {})[name] = ms
        rows.setdefault("total s", {})[name] = res.get("total_s")
    width = max(len(n) for n in names) + 2
    print(f"{'ms per launch':44s}" + "".join(f"{n:>{width}s}" for n in names))
    for label, by_run in rows.items():
        cells = "".join(
            f"{by_run[n]:>{width}.4f}" if by_run.get(n) is not None
            else f"{'-':>{width}s}" for n in names)
        print(f"{label[:44]:44s}{cells}")
    values = [dict(exact_values({p: r.get(p) for p in PHASES}))
              for r in runs]
    differ = [path for path in values[0]
              if any(v.get(path) != values[0][path] for v in values[1:])]
    missing = sorted(set().union(*values) - set(values[0]))
    print(f"{len(values[0])} non-timing values compared across "
          f"{len(runs)} runs: {len(differ)} differ")
    for path in differ + missing:
        print(f"  {path}: " + " | ".join(repr(v.get(path)) for v in values))
    return 1 if differ or missing else 0


if __name__ == "__main__":
    sys.exit(main())
