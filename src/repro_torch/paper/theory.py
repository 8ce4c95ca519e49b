"""Theorem 1: empirical average regret along an MU merge chain vs the
G²(log t + 1)/(2λt) bound, on each Table-I surrogate geometry (reduced dim
for reuters so w* is computable quickly).

Counterpart of ``benchmarks/paper_theory.py``."""
from __future__ import annotations

import numpy as np

from repro_torch.core.theory import mu_chain_regret
from repro_torch.data.synthetic import make_linear_dataset
from repro_torch.paper.common import write_csv

GEOMS = {
    # name -> (n, d, lam)
    "reuters-like": (500, 256, 1e-2),
    "spambase-like": (1000, 57, 1e-3),
    "malicious-urls-like": (2000, 10, 1e-2),
}


def run(quick: bool = False, device=None):
    rows = []
    steps = 120 if quick else 400
    for name, (n, d, lam) in GEOMS.items():
        rng = np.random.default_rng(0)
        X, y = make_linear_dataset(rng, n, d, noise=0.05, separation=3.0)
        tr = mu_chain_regret(X, y, lam=lam, steps=steps, seed=0,
                             device=device)
        for i in range(0, len(tr.t), max(len(tr.t) // 12, 1)):
            rows.append((name, tr.t[i], round(tr.avg_regret[i], 5),
                         round(tr.bound[i], 5)))
        print(f"theory,{name},holds={tr.holds},"
              f"final_avg_regret={tr.avg_regret[-1]:.5f},"
              f"final_bound={tr.bound[-1]:.5f}")
        assert tr.holds, f"Theorem 1 bound violated on {name}"
    write_csv("theory_theorem1", "geometry,t,avg_regret,bound", rows)
    return rows
