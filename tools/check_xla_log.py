#!/usr/bin/env python
"""Hold the port's ``random.log_xla`` / ``random.log1p_xla`` to XLA's own
float32 ``log`` / ``log1p`` (``jax.jit`` on the CPU) on every float32 word
of a range, bit for bit.

Usage (from the repository root, on the CPU):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/check_xla_log.py \
        --workers 6 [log|log1p|all]

``log`` walks the words 0x00000000 .. 0x7F800001 (+0, the subnormals,
every positive float, +inf and one NaN); ``log1p`` those and 0x80000000
.. 0xBF800000 (-0 down to -1); ``all`` both. The words go in slices of
2^22 to ``--workers`` processes of one thread each. Prints each slice's
count of words that differ (with the first few) and exits 1 if any do.
About 1.5 us a word a process: ``all`` takes ~30 minutes at 6 workers."""
from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ProcessPoolExecutor

SLICE = 1 << 22
RANGES = {"log": [(0x00000000, 0x7F800002)],
          "log1p": [(0x00000000, 0x7F800002), (0x80000000, 0xBF800001)]}


def check(task):
    name, lo, hi = task
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro_torch import random
    torch.set_num_threads(1)
    words = np.arange(lo, hi, dtype=np.uint32)
    x = words.view(np.float32)
    want = np.asarray(jax.jit(getattr(jnp, name))(x)).view(np.uint32)
    got = getattr(random, f"{name}_xla")(torch.from_numpy(x)).numpy().view(
        np.uint32)
    bad = np.nonzero(got != want)[0]
    return name, lo, hi, len(bad), [hex(w) for w in words[bad[:5]]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="all",
                    choices=("log", "log1p", "all"))
    ap.add_argument("--workers", type=int, default=os.cpu_count())
    opts = ap.parse_args()
    names = ("log", "log1p") if opts.which == "all" else (opts.which,)
    tasks = [(name, a, min(a + SLICE, hi)) for name in names
             for lo, hi in RANGES[name] for a in range(lo, hi, SLICE)]
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["OMP_NUM_THREADS"] = "1"
    differ = 0
    with ProcessPoolExecutor(opts.workers) as pool:
        for name, lo, hi, n_bad, first in pool.map(check, tasks):
            differ += n_bad
            if n_bad:
                print(f"{name} {lo:#010x}..{hi:#010x}: {n_bad} words differ, "
                      f"first {first}", flush=True)
    words = sum(t[2] - t[1] for t in tasks)
    print(f"{'/'.join(names)}: {words} float32 words, {differ} differ from "
          "jax.jit")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
