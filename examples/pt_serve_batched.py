"""Batched serving on the PyTorch/CUDA port: answer live queries from a
running gossip run.

The port's counterpart of ``examples/serve_batched.py``: a gossip protocol
runs underneath (either engine), a ``GossipServer`` adopts a fresh
``QuerySnapshot`` at every eval point, and a stream of feature-vector
queries drawn from the held-out test set (so every answer has a label) is
batched and answered with the cache majority vote, on the voted-predict
kernel on the card. Prints queries/s, p50/p99 batch latency and the
fresh-vs-voted accuracy of the served answers.

    PYTHONPATH=src python examples/pt_serve_batched.py
    PYTHONPATH=src python examples/pt_serve_batched.py --nodes 100000 \\
        --scenario extreme --wire-dtype int4 --trace results/pt_serve.json
    PYTHONPATH=src python examples/pt_serve_batched.py --nodes 2000 \\
        --cycles 10 --device cpu                   # the plain versions

It runs on the CUDA card unless ``--device cpu`` is given. ``--trace``
arms the protocol and the server on one Telemetry (bit for bit invisible
to both): the per-phase summary then holds the engine's spans, the
server's ``snapshot_adopt`` and ``serve_batch`` spans and the batch
latency histogram, and the Chrome trace goes to the given path.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.gossip_linear import FAILURE_SCENARIOS
from repro_torch.core.serving import ASSIGN_POLICIES
from repro_torch.core.wire_codec import WIRE_CODECS


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=10_000)
    ap.add_argument("--cycles", type=int, default=50)
    ap.add_argument("--dim", type=int, default=57)
    ap.add_argument("--engine", choices=["reference", "sharded"],
                    default="sharded")
    ap.add_argument("--scenario", choices=sorted(FAILURE_SCENARIOS),
                    default="clean",
                    help="failure operating point the protocol runs under "
                         "while serving")
    ap.add_argument("--wire-dtype", choices=sorted(WIRE_CODECS),
                    default="f32",
                    help="wire codec for the protocol's transmitted models "
                         "(serving reads snapshots after decode)")
    ap.add_argument("--batch", type=int, default=256,
                    help="serving batch size (tail batches are padded to it)")
    ap.add_argument("--queries", type=int, default=2048,
                    help="queries submitted per eval-point snapshot")
    ap.add_argument("--policy", choices=ASSIGN_POLICIES, default="uniform",
                    help="node-assignment policy: which node answers each "
                         "query")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="arm telemetry across the protocol and the server: "
                         "print the per-phase span summary and write a "
                         "Chrome trace to this path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args()

    from repro_torch.configs.gossip_linear import (GossipLinearConfig,
                                                   with_failure_scenario)
    from repro_torch.core.simulation import run_simulation
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.data.synthetic import make_linear_dataset
    from repro_torch.launch.gossip_serve import GossipServer
    from repro_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    n, d = args.nodes, args.dim
    wire = None if args.wire_dtype == "f32" else args.wire_dtype
    n_test = max(args.queries, 512)
    rng = np.random.default_rng(0)
    X, y = make_linear_dataset(rng, n + n_test, d, noise=0.07,
                               separation=2.5)
    cfg = with_failure_scenario(
        GossipLinearConfig(name=f"serve-{n}", dim=d, n_nodes=n,
                           n_test=n_test, class_ratio=(1, 1), lam=1e-3,
                           variant="mu", cache_size=4, wire_dtype=wire),
        args.scenario)
    X_test, y_test = X[n:], y[n:]

    tel = (Telemetry(label=f"pt_serve_batched N={n} {args.scenario}")
           if args.trace else None)
    srv = GossipServer(batch_size=args.batch, policy=args.policy,
                       telemetry=tel)
    qrng = np.random.default_rng(7)
    labels = []

    def serve_hook(cycle, snapshot):
        srv.serve_hook(cycle, snapshot)
        idx = qrng.integers(0, n_test, args.queries)
        labels.append(y_test[idx])
        srv.submit(X_test[idx])

    print(f"N={n:,} peers, d={d}, {args.cycles} cycles, "
          f"engine={args.engine}, scenario={args.scenario}, "
          f"wire={args.wire_dtype}, device={dev}; serving {args.queries} "
          f"queries per eval point in batches of {args.batch} "
          f"({args.policy} assignment)")
    res = run_simulation(cfg, X[:n], y[:n], X_test, y_test,
                         cycles=args.cycles,
                         eval_every=max(args.cycles // 5, 1), seed=0,
                         engine=args.engine, serve_hook=serve_hook,
                         telemetry=tel, device=dev)
    srv.flush()

    y_served = np.concatenate(labels)
    acc_voted = float(np.mean(srv.answers() == y_served))
    acc_fresh = float(np.mean(srv.answers_fresh() == y_served))
    s = srv.stats()

    print(f"\n  {'cycle':>6} {'err(fresh)':>11} {'err(voted)':>11} "
          f"{'served batches':>15}")
    per_cycle = {}
    for b in srv.batches:
        per_cycle[b.cycle] = per_cycle.get(b.cycle, 0) + 1
    for cyc, ef, ev in zip(res.cycles, res.err_fresh, res.err_voted):
        print(f"  {cyc:>6} {ef:>11.4f} {ev:>11.4f} "
              f"{per_cycle.get(int(cyc), 0):>15}")
    print(f"\nserved {s.queries:,} queries in {s.batches} batches: "
          f"{s.queries_per_sec:,.0f} queries/s, "
          f"p50 {s.p50_latency_s * 1e3:.3f} ms / "
          f"p99 {s.p99_latency_s * 1e3:.3f} ms per batch")
    print(f"accuracy of served answers: voted {acc_voted:.4f} "
          f"vs fresh {acc_fresh:.4f} "
          f"(voted - fresh = {acc_voted - acc_fresh:+.4f})")

    if tel is not None:
        print("\n" + tel.phase_report())
        fp = tel.export_chrome_trace(args.trace)
        print(f"trace written to {fp}; summarize with: "
              f"python tools/trace_report.py {fp}")


if __name__ == "__main__":
    main()
