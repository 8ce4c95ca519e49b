"""Fig. 2: MU vs UM vs PERFECT MATCHING + model-similarity (cosine).

Counterpart of ``benchmarks/paper_fig2.py``. Claims checked: MU >= UM in
convergence speed (despite UM's single-step advantage, Section V-B);
perfect matching does not clearly beat uniform sampling for Pegasos;
similarity correlates with error."""
from __future__ import annotations

import dataclasses

from repro_torch.core.simulation import run_simulation
from repro_torch.paper.common import dataset, write_csv


def run(quick: bool = False, datasets=("spambase", "malicious-urls"),
        device=None):
    cycles = 60 if quick else 300
    if quick:
        datasets = ("spambase",)
    rows = []
    for name in datasets:
        X, y, Xt, yt, cfg = dataset(name)
        runs = [
            ("mu", "uniform"),
            ("um", "uniform"),
            ("mu", "matching"),
        ]
        for variant, sampler in runs:
            c = dataclasses.replace(cfg, variant=variant)
            res = run_simulation(c, X, y, Xt, yt, cycles=cycles,
                                 eval_every=max(cycles // 15, 1), seed=0,
                                 sampler=sampler, engine="sharded",
                                 device=device)
            label = f"{variant}-{sampler}"
            for cyc, e, s in zip(res.cycles, res.err_fresh, res.similarity):
                rows.append((name, label, cyc, round(e, 4), round(s, 4)))
            print(f"fig2,{name},{label},final_err={res.err_fresh[-1]:.4f},"
                  f"final_similarity={res.similarity[-1]:.3f}")
    write_csv("fig2", "dataset,algorithm,cycle,err,similarity", rows)
    return rows
