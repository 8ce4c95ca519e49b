#!/usr/bin/env python
"""Time the send kernels of several source trees in turns on one card.

Each tree (a checkout of the repository, e.g. a parent commit unpacked
with ``git archive`` beside the change) runs in a process of its own, in
the order given (typically parent, change, change, parent), with its own
``chip_smoke.py``: it builds its ``quantize_send`` library, counts
int8_sr's threefry instructions in that build's SASS (``threefry_sass``)
and times both send routes of every codec at N = 10^6 and the widths of
``send_width_sweep``, with the bound computed from that count. Prints one
JSON line per run and a table of the tiled route's int8 and int8_sr times
and bounds by run:

    python tools/time_send_trees.py _parent . . _parent \\
        --out results/send_trees.json

Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# run inside one tree: its own chip_smoke helpers on its own kernels
_CHILD = r"""
import json, sys
sys.path.insert(0, "src")
import torch
import chip_smoke as cs
from repro_torch.kernels import _build
_build.build(["quantize_send"])
card = cs.smi()
threefry = cs.threefry_sass(_build.library_path("quantize_send"))
sweep = cs.send_width_sweep(card, threefry, torch.device("cuda"))
print("RESULT " + json.dumps({"card": card, "threefry": threefry,
                              "sweep": sweep}))
"""


def run_tree(tree: Path) -> dict:
    """One tree's threefry count and send sweep, from a process of its
    own started in the tree."""
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{tree}: exit {proc.returncode}\n{proc.stdout}\n"
                         f"{proc.stderr}")
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", type=Path,
                    help="source trees, in run order")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every run's result to this JSON file")
    opts = ap.parse_args()
    runs = []
    for tree in opts.trees:
        res = run_tree(tree.resolve())
        res["tree"] = str(tree)
        runs.append(res)
        print(json.dumps(res), flush=True)
    print(f"card: {runs[0]['card']}")
    print("tree | threefry int32/imad an element | d | int8 tiled ms | "
          "int8_sr tiled ms | int8_sr bound ms")
    for res in runs:
        tf = res["threefry"]
        for d, row in res["sweep"].items():
            print(f"{res['tree']} | {tf['int32']:g}/{tf['imad']:g} | {d} | "
                  f"{row['int8']['tiled_ms']:.4f} | "
                  f"{row['int8_sr']['tiled_ms']:.4f} | "
                  f"{row['int8_sr']['bound_ms']:.4f}")
    if opts.out is not None:
        opts.out.parent.mkdir(parents=True, exist_ok=True)
        opts.out.write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
