"""The paper's experiments on the port: Fig. 1-3, Table I and Theorem 1.

Counterparts of the JAX package's ``benchmarks/paper_*.py`` drivers, each
with the same ``run(quick=False, ...)`` signature (plus ``device``), the
same rows, CSV header and printed lines. The protocol runs take the sharded
engine (``run_simulation(..., engine="sharded")``: kernel #1 on the card),
the bagging and sequential baselines kernel #6. CSVs go to
``results/pt_paper/``. ``python -m repro_torch.paper [--quick] [names...]``
runs them in the order of ``benchmarks/run.py``'s paper entries.
"""
