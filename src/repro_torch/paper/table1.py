"""Table I: datasets + sequential Pegasos (20,000 iterations) 0-1 error.

Counterpart of ``benchmarks/paper_table1.py``. Paper values (on the UCI
originals): Reuters 0.025, SpamBase 0.111, Malicious URLs(10) 0.080. The
surrogates (same dim / sizes / class ratio; see
``repro_torch.data.synthetic``) are calibrated to land near these floors,
so the gossip dynamics run on comparable geometry. ``us_per_iter`` is the
chain's wall time an iteration: one launch of kernel #6 at N = 1 each on
the card, so it measures the host's cost of a launch.
"""
from __future__ import annotations

import time

from repro_torch.core.ensemble import run_sequential_pegasos
from repro_torch.paper.common import dataset, write_csv

PAPER = {"reuters": 0.025, "spambase": 0.111, "malicious-urls": 0.080}


def run(quick: bool = False, device=None):
    rows = []
    iters = 2000 if quick else 20_000
    for name, target in PAPER.items():
        X, y, Xt, yt, cfg = dataset(name)
        t0 = time.time()
        _, pts = run_sequential_pegasos(X, y, Xt, yt, iters=iters,
                                        lam=cfg.lam, eval_every=iters,
                                        device=device)
        err = pts[-1][1]
        us = (time.time() - t0) / iters * 1e6
        rows.append((name, X.shape[0], Xt.shape[0], X.shape[1],
                     round(err, 4), target, round(us, 2)))
        print(f"table1,{name},err={err:.4f},paper={target},us_per_iter={us:.1f}")
    write_csv("table1", "dataset,n_train,n_test,dim,err,paper_err,us_per_iter",
              rows)
    return rows
