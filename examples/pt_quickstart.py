"""Quickstart on the PyTorch/CUDA port: the paper's protocol in ~30 lines
of driver code.

The port's counterpart of ``examples/quickstart.py``. Runs gossip learning
(P2PegasosMU) on the Spambase surrogate (4,140 peers, ONE data record
each) and prints the 0-1 test error of the freshest and the voted
(cache-of-10) local predictions every few cycles, next to the
independent-random-walk baseline (P2PegasosRW = sequential Pegasos).

    PYTHONPATH=src python examples/pt_quickstart.py [--cycles 120]
    PYTHONPATH=src python examples/pt_quickstart.py --device cpu

Expected: MU converges orders of magnitude faster than RW (the paper's
headline Fig. 1 claim); voting helps RW a lot and MU a little (Fig. 3).

It runs on the CUDA card unless ``--device`` names another. The default
engine is the sharded one (the receive kernel on the card);
``--engine reference`` runs the port's Python-driven cycle loop, with the
same seed and the same curves.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.core.simulation import run_simulation
from repro_torch.data.synthetic import paper_dataset


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cycles", type=int, default=120)
    ap.add_argument("--dataset", default="spambase",
                    choices=["spambase", "reuters", "malicious-urls"])
    ap.add_argument("--engine", default="sharded",
                    choices=["reference", "sharded"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args()

    X, y, Xt, yt, cfg = paper_dataset(args.dataset)
    print(f"dataset={cfg.name}: N={X.shape[0]} peers (one record each), "
          f"d={X.shape[1]}, test={Xt.shape[0]}")

    for variant in ("rw", "mu"):
        c = dataclasses.replace(cfg, variant=variant)
        res = run_simulation(c, X, y, Xt, yt, cycles=args.cycles,
                             eval_every=max(args.cycles // 8, 1), seed=0,
                             engine=args.engine, device=args.device)
        print(f"\nP2Pegasos{variant.upper()}")
        print(f"  {'cycle':>6} {'err(fresh)':>11} {'err(voted)':>11} "
              f"{'model-similarity':>17}")
        for cyc, ef, ev, sim in zip(res.cycles, res.err_fresh,
                                    res.err_voted, res.similarity):
            print(f"  {cyc:>6} {ef:>11.4f} {ev:>11.4f} {sim:>17.4f}")


if __name__ == "__main__":
    main()
