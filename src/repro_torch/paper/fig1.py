"""Fig. 1: prediction-error convergence, no-failure vs all-failures (AF).

Counterpart of ``benchmarks/paper_fig1.py``. Curves per dataset:
P2PegasosRW, P2PegasosMU, WB1, WB2 (Eqs. 18-19), in the failure-free
setting and under AF (drop 0.5, delay U[Δ,10Δ], churn 90% online). The
paper's headline claims checked here:
  * MU converges orders of magnitude faster than RW (log-scale cycles);
  * MU tracks WB2 with a small delay;
  * AF costs roughly a constant slowdown factor (≈ delay x drop), not
    convergence.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.ensemble import run_weighted_bagging
from repro_torch.core.simulation import run_simulation
from repro_torch.paper.common import dataset, write_csv

AF = dict(drop_prob=0.5, delay_max_cycles=10, online_fraction=0.9)


def run(quick: bool = False,
        datasets=("spambase", "malicious-urls", "reuters"), device=None):
    cycles = 60 if quick else 300
    if quick:
        datasets = ("spambase",)
    rows = []
    for name in datasets:
        X, y, Xt, yt, cfg = dataset(name)
        n = X.shape[0]
        for failure, fkw in [("none", {}), ("af", AF)]:
            for variant in ("rw", "mu"):
                c = dataclasses.replace(cfg, variant=variant, **fkw)
                res = run_simulation(c, X, y, Xt, yt, cycles=cycles,
                                     eval_every=max(cycles // 15, 1), seed=0,
                                     engine="sharded", device=device)
                for cyc, e in zip(res.cycles, res.err_fresh):
                    rows.append((name, failure, f"p2pegasos-{variant}", cyc,
                                 round(e, 4)))
                print(f"fig1,{name},{failure},{variant},final={res.err_fresh[-1]:.4f}")
        bag = run_weighted_bagging(X, y, Xt, yt, n_models=min(n, 2048),
                                   cycles=cycles, lam=cfg.lam,
                                   eval_every=max(cycles // 15, 1),
                                   device=device)
        for cyc, e1, e2 in zip(bag.cycles, bag.err_wb1, bag.err_wb2):
            rows.append((name, "none", "wb1", cyc, round(e1, 4)))
            rows.append((name, "none", "wb2", cyc, round(e2, 4)))
        print(f"fig1,{name},none,wb1,final={bag.err_wb1[-1]:.4f}")
        print(f"fig1,{name},none,wb2,final={bag.err_wb2[-1]:.4f}")
    write_csv("fig1", "dataset,failure,algorithm,cycle,err", rows)
    return rows
