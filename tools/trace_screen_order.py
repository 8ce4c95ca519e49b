#!/usr/bin/env python
"""Trace the screen verdicts that the order of the screen's sums decides.

    PYTHONPATH=src python tools/trace_screen_order.py [--nodes 20000]
        [--defense norm_clip] [--device cpu]

Runs ``chip_smoke.py`` phase 2's sign_flip run (N nodes, d = 10, the
extreme scenario, MU, K = 4, cache 10, 20 cycles, 10 % sign_flip
Byzantine senders, the given defense, seed 0) on the port's reference
engine twice:

- with the screen's sums in sequence from +0.0 (``faults._screen_sum``,
  XLA's order at d <= 32, which the plain version and both routes of the
  receive kernel use);
- with each sum a G-lane xor butterfly of partials that start at +0.0
  (the receive kernel's grouped route before its screen summed in
  sequence: G = 16 lanes at d = 10).

Prints each run's fault counters and, for the first screen call, round
and node whose verdict differs, the node's sq, rn and threshold under both
orders, bit for bit. Needs only the port: it runs on the CPU, or on a card
with ``--device cuda``."""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from repro_torch.configs.gossip_linear import (GossipLinearConfig,
                                               with_failure_scenario)
from repro_torch.core import faults
from repro_torch.core.simulation import run_simulation
from repro_torch.data.synthetic import make_linear_dataset

K_ROUNDS = 4


def butterfly_sum(terms):
    """The (m, d) terms' sums as the grouped kernel's xor butterfly over
    G = 2^ceil(log2 d) lanes: lane j < d holds 0.0 + term j, the rest
    +0.0; levels G/2 ... 1, each lane adding its partner's partial."""
    m, d = terms.shape
    g = 1 << max(d - 1, 0).bit_length()
    lanes = torch.zeros(m, g, dtype=terms.dtype, device=terms.device)
    lanes[:, :d] = 0.0 + terms
    idx = torch.arange(g, device=terms.device)
    o = g // 2
    while o:
        lanes = lanes + lanes[:, idx ^ o]
        o //= 2
    return lanes[:, 0]


def run(cfg, data, device, order, reference=None):
    """One reference-engine run with ``order`` as the screen's sum. Each
    screen call's (gated, clipped) verdicts are recorded; against
    ``reference`` (another run's record) the first call and node whose
    verdict differs is kept with its sums under both orders. Returns the
    result, the record and that first difference (or None)."""
    record, first = [], []
    screen, plain_sum = faults.apply_defense, faults._screen_sum

    def traced(defense, msg_w, valid, recv_w):
        faults._screen_sum = order
        try:
            out = screen(defense, msg_w, valid, recv_w)
        finally:
            faults._screen_sum = plain_sum
        verdict = (out[2].cpu(), out[3].cpu())
        call = len(record)
        record.append(verdict)
        if reference is not None and not first:
            want = reference[call]
            moved = (verdict[0] != want[0]) | (verdict[1] != want[1])
            if bool(moved.any()):
                i = int(torch.nonzero(moved)[0])
                m, r = faults._ftz(msg_w[i:i + 1]), faults._ftz(
                    recv_w[i:i + 1])
                first.append(dict(call=call, node=i, sums={
                    name: (float(fn(faults._ftz(m * m))[0]),
                           float(fn(faults._ftz(r * r))[0]))
                    for name, fn in (("sequential", plain_sum),
                                     ("butterfly", butterfly_sum))}))
        return out

    faults.apply_defense = traced
    try:
        res = run_simulation(cfg, *data, engine="reference", device=device,
                             cycles=20, eval_every=10, seed=0,
                             k_rounds=K_ROUNDS)
    finally:
        faults.apply_defense = screen
    return res, record, first[0] if first else None


def bits(v: float) -> str:
    return f"{v!r} (0x{np.float32(v).view(np.uint32):08x})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=20_000)
    ap.add_argument("--defense", default="norm_clip",
                    choices=("norm_clip", "cosine_gate"))
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    n = args.nodes
    X, y = make_linear_dataset(np.random.default_rng(0), n + 1000, 10,
                               noise=0.07, separation=2.5)
    cfg = dataclasses.replace(with_failure_scenario(GossipLinearConfig(
        name="trace", dim=10, n_nodes=n, n_test=1000, class_ratio=(1, 1),
        lam=1e-3, variant="mu", cache_size=10), "extreme"),
        fault_model="sign_flip", byzantine_frac=0.1, defense=args.defense)
    data = (X[:n], y[:n], X[n:], y[n:])
    seq, record, _ = run(cfg, data, args.device, faults._screen_sum)
    fly, _, first = run(cfg, data, args.device, butterfly_sum, record)
    print(f"N={n} sign_flip 10% {args.defense}, 20 cycles, reference "
          f"engine on {args.device}:")
    print(f"  sums in sequence (XLA's order): {seq.fault_stats}")
    print(f"  sums by 16-lane butterfly:      {fly.fault_stats}")
    if first is None:
        print("  no verdict differs")
        return 0
    cycle, rnd = divmod(first["call"], K_ROUNDS)
    print(f"  first verdict that differs: cycle {cycle}, round {rnd}, node "
          f"{first['node']}")
    for name, (sq, rn) in first["sums"].items():
        thr = np.maximum(np.float32(faults.NORM_CLIP_MULT_SQ)
                         * np.float32(rn), np.float32(
                             faults.NORM_CLIP_FLOOR_SQ))
        print(f"    {name:10s} sq {bits(sq)}, rn {bits(rn)}, threshold "
              f"{bits(float(thr))}, sq > threshold: {np.float32(sq) > thr}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
