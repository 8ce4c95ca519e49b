"""The paper's robustness claim, end to end (Fig. 1 lower row / Fig. 3), on
the PyTorch/CUDA port.

The port's counterpart of ``examples/robustness_failures.py``. Runs
P2PegasosMU under the paper's EXTREME failure model (50% message drop,
message delay uniform in [Δ, 10Δ], churn with 90% online: lognormal
sessions, state retained offline) and shows that convergence slows by
roughly the predicted constant factor (≈ mean delay × 1/(1-drop)) but does
NOT stall or diverge.

    PYTHONPATH=src python examples/pt_robustness_failures.py --cycles 200
    PYTHONPATH=src python examples/pt_robustness_failures.py --trace out.json

It runs the sharded engine (the receive kernel) on the CUDA card unless
``--device`` names another. ``--trace`` arms one
``repro_torch.core.telemetry.Telemetry`` across the sweep (bit for bit
invisible to the runs): it prints the per-phase span summary and writes a
Chrome trace whose metric streams concatenate the five runs in sweep
order, which ``tools/trace_report.py`` summarizes.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.core.simulation import run_simulation
from repro_torch.core.telemetry import Telemetry
from repro_torch.data.synthetic import paper_dataset

SCENARIOS = {
    "none": {},
    "drop .5": dict(drop_prob=0.5),
    "delay U[Δ,10Δ]": dict(delay_max_cycles=10),
    "churn 90%": dict(online_fraction=0.9),
    "all failures": dict(drop_prob=0.5, delay_max_cycles=10,
                         online_fraction=0.9),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cycles", type=int, default=200)
    ap.add_argument("--dataset", default="spambase")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="arm one telemetry object across the whole sweep "
                         "(bitwise invisible): print the per-phase span "
                         "summary and export a Chrome trace; the metric "
                         "streams concatenate the five scenario runs in "
                         "sweep order")
    args = ap.parse_args()

    # one Telemetry across the sweep: spans share a wall-clock origin and
    # streams concatenate per run
    tel = Telemetry(label=f"robustness sweep {args.dataset}") \
        if args.trace else None

    X, y, Xt, yt, cfg = paper_dataset(args.dataset)
    print(f"dataset={cfg.name}: N={X.shape[0]}, extreme-failure sweep, "
          f"P2PegasosMU, {args.cycles} cycles\n")
    print(f"{'scenario':>16} {'err(fresh)':>11} {'err(voted)':>11}")
    for label, kw in SCENARIOS.items():
        c = dataclasses.replace(cfg, variant="mu", **kw)
        res = run_simulation(c, X, y, Xt, yt, cycles=args.cycles,
                             eval_every=args.cycles, seed=0, telemetry=tel,
                             engine="sharded", device=args.device)
        print(f"{label:>16} {res.err_fresh[-1]:>11.4f} "
              f"{res.err_voted[-1]:>11.4f}")

    if tel is not None:
        print("\n" + tel.phase_report())
        fp = tel.export_chrome_trace(args.trace)
        print(f"trace written to {fp}; open at https://ui.perfetto.dev "
              f"or summarize with: python tools/trace_report.py {fp}")


if __name__ == "__main__":
    main()
