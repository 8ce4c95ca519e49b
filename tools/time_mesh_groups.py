#!/usr/bin/env python
"""Time the mesh tests' shared ``gloo`` groups in several checkouts, in
turns, on the CPU.

Usage (from the repository root):

    python tools/time_mesh_groups.py _parent . . _parent

Each ROOT is a checkout (a tree unpacked with ``git archive`` will do). For
each, in the order given, a process of its own imports that tree's
``tests/torch_mesh_cases.py`` and ``src/repro_torch`` and starts every
group of its ``GROUPS`` at once, as ``shared_ranks`` does in a test
session, then prints each group's wall time and the whole set's (the
longest group: what the first mesh test's setup waits for). Run it on an
otherwise idle machine; the groups share its cores."""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# run inside each tree's own process: argv[1] the tree
_CHILD = r"""
import json, sys, time
from concurrent.futures import ThreadPoolExecutor
root = sys.argv[1]
sys.path[:0] = [root + "/tests", root + "/src"]
import torch_mesh_cases as C
from repro_torch.launch.mesh import run_ranks


def one(name, spec):
    world, fn = spec if isinstance(spec, tuple) else (name, spec)
    t0 = time.perf_counter()
    run_ranks(fn, world, device_type="cpu", timeout_s=400.0,
              pg_timeout_s=120.0)
    return time.perf_counter() - t0


if __name__ == "__main__":
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(C.GROUPS)) as pool:
        runs = {str(g): pool.submit(one, g, s) for g, s in C.GROUPS.items()}
        walls = {g: r.result() for g, r in runs.items()}
    print(json.dumps({"walls": walls, "set": time.perf_counter() - t0}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", help="checkouts, in the order run")
    opts = ap.parse_args()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    rows = []
    for root in opts.roots:
        root = str(Path(root).resolve())
        out = subprocess.run([sys.executable, "-c", _CHILD, root], env=env,
                             capture_output=True, text=True, check=True,
                             cwd=root)
        last = out.stdout.strip().splitlines()[-1]
        row = dict(root=root, **json.loads(last))
        rows.append(row)
        walls = ", ".join(f"{g} {s:.1f} s" for g, s in row["walls"].items())
        print(f"{root}: {walls}; the set {row['set']:.1f} s", flush=True)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
