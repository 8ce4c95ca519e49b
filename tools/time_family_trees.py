#!/usr/bin/env python
"""Run one of ``chip_smoke.py``'s ``FAMILY_RUNS`` in several checkouts, in
turns, on one card.

Usage (from the repository root, on a machine with the card):

    python tools/time_family_trees.py --arch recurrentgemma-9b \
        _parent . . _parent

Each ROOT is a checkout (a tree unpacked with ``git archive`` will do). For
each, in the order given, a process of its own imports that tree's
``chip_smoke.py`` and ``src/repro_torch``, builds that tree's kernels and
runs its ``family_run`` for ARCH: the served run with kernel #8's launches
counted by route, the plain attention path's run and #8 on the last
attention layer's q, k, v. Prints each run's prefill wall, decode ms a
step, #8's launches by route and its ms, the path agreement, then one JSON
line with every run's numbers. Comparing trees inside one call keeps the
card, its power limit and its host the same."""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# run inside each tree's own process: argv[1] the tree, argv[2] the arch
_CHILD = r"""
import json, sys
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import torch
import chip_smoke as cs
run = next(r for r in cs.FAMILY_RUNS if r[0] == sys.argv[2])
res = cs.family_run(cs.smi(), torch.device("cuda"), run)
fl = res.get("flash", {})
print("RESULT " + json.dumps(dict(
    card=cs.smi(), prefill_ms=res["prefill_s"] * 1e3,
    decode_ms_per_step=res["decode_ms_per_step"],
    route_launches=res["route_launches"], flash_ms=fl.get("ms"),
    flash_plain_ms=fl.get("plain_ms"), flash_library_ms=fl.get("library_ms"),
    flash_bound_ms=fl.get("bound_ms"),
    logit_diff=res.get("plain_path", {}).get("logit_diff"),
    plain_prefill_ms=res.get("plain_path", {}).get("prefill_s", 0) * 1e3)))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True,
                    help="an arch of chip_smoke.FAMILY_RUNS with attention")
    ap.add_argument("roots", nargs="+", help="checkouts, in the order to run")
    opts = ap.parse_args()
    runs = []
    for root in opts.roots:
        path = str(Path(root).resolve())
        proc = subprocess.run([sys.executable, "-c", _CHILD, path, opts.arch],
                              capture_output=True, text=True, cwd=path)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"{root}: the family run failed "
                             f"(exit {proc.returncode})")
        res = dict(json.loads(lines[-1][len("RESULT "):]), root=root)
        runs.append(res)
        print(f"{root}: {opts.arch} prefill {res['prefill_ms']:.1f} ms "
              f"(plain attention path {res['plain_prefill_ms']:.1f}), decode "
              f"{res['decode_ms_per_step']:.2f} ms/step; #8 "
              f"{res['route_launches']} at {res['flash_ms']:.4f} ms/launch "
              f"(bound {res['flash_bound_ms']:.4f}, plain "
              f"{res['flash_plain_ms']:.4f}, SDPA "
              f"{res['flash_library_ms']:.4f}); path agreement "
              f"{res['logit_diff']:.4f}; {res['card']}", flush=True)
    print(json.dumps({"arch": opts.arch, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
