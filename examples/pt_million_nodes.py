"""Gossip learning at a million nodes on the PyTorch/CUDA port.

The port's counterpart of ``examples/million_nodes.py``: the sharded
engine (``repro_torch.core.sharded_engine``: the numpy router on the host,
the hand-written receive and send kernels on the card) runs the paper's
protocol at N = 10^6 and prints the error curve, node-cycles/s, the
message economy and the compaction report (the packing each chunk took
and the receivers' occupancy). ``--scenario sparse`` (80 % drop, 10 %
online) picks ``compact_all`` where compacting is on, and the extreme
scenario ``compact``; on the card Pegasos stays dense unless
``--compact`` allows the packings.

    PYTHONPATH=src python examples/pt_million_nodes.py                # 10^6 nodes
    PYTHONPATH=src python examples/pt_million_nodes.py --scenario extreme \\
        --wire-dtype int4_ef --trace results/pt_trace.json
    PYTHONPATH=src python examples/pt_million_nodes.py --scenario sparse \\
        --compact                                  # compact_all on the card
    PYTHONPATH=src python examples/pt_million_nodes.py --nodes 2000 \\
        --cycles 10 --device cpu                   # the plain versions

It runs on the CUDA card unless ``--device cpu`` is given. ``--trace``
arms telemetry (bit for bit invisible to the run): it prints the
per-phase split of the host's time (``setup``, ``draw_enqueue``,
``draw_readback``, ``route_chunk``, ``pack_tables``, ``dense_table``,
``table_upload``,
``chunk_dispatch``, ``eval``, ``collect_results``; see
``repro_torch.core.telemetry.SPAN_NAMES``) and writes a Chrome trace with
the per-cycle metric streams, which ``tools/trace_report.py`` summarizes
and https://ui.perfetto.dev shows.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.gossip_linear import FAILURE_SCENARIOS
from repro_torch.core.wire_codec import WIRE_CODECS

# short spellings, as examples/million_nodes.py has them; every registered
# FAILURE_SCENARIOS key is accepted too
SCENARIO_ALIASES = {"sparse": "sparse-d0.8-o0.1"}
SCENARIO_CHOICES = sorted(SCENARIO_ALIASES) + sorted(FAILURE_SCENARIOS)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=1_000_000)
    ap.add_argument("--cycles", type=int, default=50)
    ap.add_argument("--dim", type=int, default=10)
    ap.add_argument("--scenario", choices=SCENARIO_CHOICES,
                    default="clean",
                    help="failure operating point: clean (no failures), "
                         "extreme (drop=0.5, 10 cycle delays, 90%% online), "
                         "sparse (alias for sparse-d0.8-o0.1, the "
                         "compact_all regime), or any registered "
                         "FAILURE_SCENARIOS key")
    ap.add_argument("--compact", action="store_true",
                    help="allow the compact packings (the default on the "
                         "CPU and for the other learners, off on the card "
                         "for Pegasos)")
    ap.add_argument("--wire-dtype", choices=sorted(WIRE_CODECS),
                    default="f32",
                    help="wire codec for the transmitted models and the "
                         "in-flight buffer; merge math stays f32")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="arm telemetry: print the per-phase span summary "
                         "and write a Chrome trace with the per-cycle "
                         "metric streams to this path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args()

    import torch

    from repro_torch.configs.gossip_linear import (GossipLinearConfig,
                                                   with_failure_scenario)
    from repro_torch.core.simulation import (message_wire_bytes,
                                             run_simulation)
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.data.synthetic import make_linear_dataset
    from repro_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    scenario = SCENARIO_ALIASES.get(args.scenario, args.scenario)
    n, d = args.nodes, args.dim
    wire = None if args.wire_dtype == "f32" else args.wire_dtype
    rng = np.random.default_rng(0)
    X, y = make_linear_dataset(rng, n + 1000, d, noise=0.07, separation=2.5)
    cfg = with_failure_scenario(
        GossipLinearConfig(name=f"million-{n}", dim=d, n_nodes=n,
                           n_test=1000, class_ratio=(1, 1), lam=1e-3,
                           variant="mu", cache_size=4, wire_dtype=wire),
        scenario)
    msg_bytes = message_wire_bytes(d, wire)
    print(f"N={n:,} peers (one record each), d={d}, {args.cycles} cycles, "
          f"variant=MU, wire={args.wire_dtype} ({msg_bytes} B/msg), "
          f"scenario={scenario} (drop={cfg.drop_prob}, delay<= "
          f"{cfg.delay_max_cycles} cycles, online="
          f"{cfg.online_fraction:.0%}), device={dev}"
          + (f" ({torch.cuda.get_device_name(dev)})"
             if dev.type == "cuda" else ""))
    tel = (Telemetry(label=f"pt_million_nodes N={n} {scenario}")
           if args.trace else None)
    t0 = time.perf_counter()
    res = run_simulation(cfg, X[:n], y[:n], X[n:], y[n:],
                         cycles=args.cycles,
                         eval_every=max(args.cycles // 5, 1), seed=0,
                         engine="sharded", telemetry=tel, device=dev,
                         compact_rounds=True if args.compact else None)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    print(f"\n  {'cycle':>6} {'err(fresh)':>11} {'err(voted)':>11}")
    for cyc, ef, ev in zip(res.cycles, res.err_fresh, res.err_voted):
        print(f"  {cyc:>6} {ef:>11.4f} {ev:>11.4f}")
    print(f"\n{n * args.cycles / dt:,.0f} node-cycles/sec ({dt:.3f}s wall)")
    print(f"economy: {res.sent_total:,} sent = {res.delivered_total:,} "
          f"delivered + {res.lost_total:,} lost + {res.overflow_total:,} "
          f"overflow + {res.in_flight_total:,} in flight")
    print(f"bandwidth: {res.wire_bytes_total / 1e9:.3f} GB on the wire, "
          f"in-flight payload buffer {res.buf_payload_bytes / 1e6:.1f} MB")
    if res.ef_residual_norm:
        print(f"error feedback: terminal EF-residual norm "
              f"{res.ef_residual_norm:.4f}")

    # compaction: what the router saw, what the engine chose
    dpc = np.asarray(res.delivered_per_cycle, dtype=np.float64)
    comp = res.compaction
    print(f"delivered/cycle: mean {dpc.mean():,.0f}, max {dpc.max():,.0f} "
          f"({dpc.mean() / n:.2%} of the population)")
    print("chunk packing: "
          + ", ".join(f"{k}={v}" for k, v in comp["chunk_modes"].items() if v)
          + f"; round-1 occupancy mean {comp['round1_occupancy_mean']:.2%} "
          f"max {comp['round1_occupancy_max']:.2%}, multi-receive mean "
          f"{comp['multi_occupancy_mean']:.2%}; packed widths "
          f"{comp['packed_widths']}")

    if tel is not None:
        print("\n" + tel.phase_report())
        fp = tel.export_chrome_trace(args.trace)
        print(f"trace written to {fp}; summarize with: "
              f"python tools/trace_report.py {fp}")


if __name__ == "__main__":
    main()
