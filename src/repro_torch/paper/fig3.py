"""Fig. 3: local voting (cache of 10, Algorithm 4) with and without
failures.

Counterpart of ``benchmarks/paper_fig3.py``. Claims checked: voting yields
a large improvement for RW, a smaller one for MU; early cycles can show
slight degradation; 'since voting is for free, it is advisable to use
it'."""
from __future__ import annotations

import dataclasses

from repro_torch.core.simulation import run_simulation
from repro_torch.paper.common import dataset, write_csv

AF = dict(drop_prob=0.5, delay_max_cycles=10, online_fraction=0.9)


def run(quick: bool = False, datasets=("spambase", "malicious-urls"),
        device=None):
    cycles = 60 if quick else 300
    if quick:
        datasets = ("spambase",)
    rows = []
    for name in datasets:
        X, y, Xt, yt, cfg = dataset(name)
        for failure, fkw in [("none", {}), ("af", AF)]:
            for variant in ("rw", "mu"):
                c = dataclasses.replace(cfg, variant=variant, **fkw)
                res = run_simulation(c, X, y, Xt, yt, cycles=cycles,
                                     eval_every=max(cycles // 15, 1), seed=0,
                                     engine="sharded", device=device)
                for cyc, ef, ev in zip(res.cycles, res.err_fresh,
                                       res.err_voted):
                    rows.append((name, failure, variant, cyc,
                                 round(ef, 4), round(ev, 4)))
                gain = res.err_fresh[-1] - res.err_voted[-1]
                print(f"fig3,{name},{failure},{variant},"
                      f"fresh={res.err_fresh[-1]:.4f},"
                      f"voted={res.err_voted[-1]:.4f},gain={gain:+.4f}")
    write_csv("fig3", "dataset,failure,variant,cycle,err_fresh,err_voted", rows)
    return rows
