"""Run the paper's experiments on the port.

    PYTHONPATH=src python -m repro_torch.paper [--quick] [--device cpu] \\
        [table1 fig1 fig2 fig3 theory]

Runs the named drivers (all five by default) in the order of
``benchmarks/run.py``'s paper entries, on the CUDA card unless
``--device`` names another, prints each driver's lines and its wall
seconds, and writes the CSVs under ``results/pt_paper/``.
"""
from __future__ import annotations

import argparse
import importlib
import time

DRIVERS = ("table1", "fig1", "fig2", "fig3", "theory")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", metavar="name",
                    help=f"drivers to run, of {', '.join(DRIVERS)} "
                         "(default: all, in that order)")
    ap.add_argument("--quick", action="store_true",
                    help="reduced cycles/iterations (the drivers' quick "
                         "settings)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.names) - set(DRIVERS))
    if unknown:
        ap.error(f"unknown driver(s) {unknown}; choose from {DRIVERS}")
    chosen = set(args.names) or set(DRIVERS)
    t0 = time.time()
    for name in DRIVERS:
        if name not in chosen:
            continue
        mod = importlib.import_module(f"repro_torch.paper.{name}")
        t1 = time.time()
        mod.run(args.quick, device=args.device)
        print(f"paper,{name},wall_s={time.time() - t1:.2f}")
    print(f"paper done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
