#!/usr/bin/env python
"""Trace the screen verdicts that the order of the screen's sums decides.

    PYTHONPATH=src python tools/trace_screen_order.py [--nodes 20000]
        [--defense norm_clip] [--device cpu]

Runs ``chip_smoke.py`` phase 2's sign_flip run (N nodes, d = 10, the
extreme scenario, MU, K = 4, cache 10, 20 cycles, 10 % sign_flip
Byzantine senders, the given defense, seed 0) on the port's reference
engine three times:

- with the screen's sums in the jitted reference's order, fused
  multiply-adds in sequence from +0.0 at d = 10 (``faults._screen_sum``,
  which the plain version and both routes of the receive kernel use);
- with the rounded products added in sequence from +0.0 (the eager
  reference's order at d <= 32, and the port's screen before it took the
  jitted order);
- with each sum a G-lane xor butterfly of partials that start at +0.0
  (the receive kernel's grouped route before its screen summed in
  sequence: G = 16 lanes at d = 10).

Prints each run's fault counters and, for the first screen call, round
and node whose verdict or rescaled message differs from the fused run's,
the node's sq, rn and threshold under all three orders, bit for bit. Needs only the port:
it runs on the CPU, or on a card with ``--device cuda``."""
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


def butterfly_sum(a, b):
    """The row sums of ``a * b`` (rounded, flushed products) as the grouped
    kernel's xor butterfly over G = 2^ceil(log2 d) lanes: lane j < d holds
    0.0 + term j, the rest +0.0; levels G/2 ... 1, each lane adding its
    partner's partial."""
    terms = faults._ftz(a * b)
    *rows, d = terms.shape
    g = 1 << max(d - 1, 0).bit_length()
    lanes = torch.zeros(*rows, g, dtype=terms.dtype, device=terms.device)
    lanes[..., :d] = 0.0 + terms
    idx = torch.arange(g, device=terms.device)
    o = g // 2
    while o:
        lanes = lanes + lanes[..., idx ^ o]
        o //= 2
    return lanes[..., 0]


def sequential_sum(a, b):
    """The row sums of the rounded, flushed products ``a * b``, added in
    sequence from +0.0."""
    return faults._in_sequence(faults._ftz(a * b))


ORDERS = (("fused", faults._screen_sum), ("sequential", sequential_sum),
          ("butterfly", butterfly_sum))


def run(cfg, data, device, order, reference=None):
    """One reference-engine run with ``order`` as the screen's sum. Each
    screen call's (gated, clipped) verdicts and screened messages are
    recorded; against ``reference`` (another run's record) the first call
    and node whose verdict or rescaled message differs is kept with its
    sums under every order. Returns the result, the record and that first
    difference (or None)."""
    record, first = [], []
    screen, plain_sum = faults.apply_defense, faults._screen_sum

    def traced(defense, msg_w, valid, recv_w):
        faults._screen_sum = order
        try:
            out = screen(defense, msg_w, valid, recv_w)
        finally:
            faults._screen_sum = plain_sum
        got = (out[2].cpu(), out[3].cpu(), out[0].cpu())
        call = len(record)
        record.append(got)
        if reference is not None and not first:
            want = reference[call]
            verdict = (got[0] != want[0]) | (got[1] != want[1])
            moved = verdict | (valid.cpu() & (
                got[2].view(torch.int32) != want[2].view(torch.int32)
            ).any(-1))
            if bool(moved.any()):
                i = int(torch.nonzero(moved)[0])
                m, r = faults._ftz(msg_w[i:i + 1]), faults._ftz(
                    recv_w[i:i + 1])
                first.append(dict(
                    call=call, node=i, kind=("verdict" if verdict[i] else
                                             "rescaled message"),
                    sums={name: (float(fn(m, m)[0]), float(fn(r, r)[0]))
                          for name, fn in ORDERS}))
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
    fused, record, _ = run(cfg, data, args.device, faults._screen_sum)
    print(f"N={n} sign_flip 10% {args.defense}, 20 cycles, reference "
          f"engine on {args.device}:")
    print(f"  fused (the jitted reference's order): {fused.fault_stats}")
    for name, order in ORDERS[1:]:
        res, _, first = run(cfg, data, args.device, order, record)
        print(f"  {name}: {res.fault_stats}")
        if first is None:
            print("    no verdict or rescaled message differs from the fused "
                  "run's")
            continue
        cycle, rnd = divmod(first["call"], K_ROUNDS)
        print(f"    first {first['kind']} that differs: cycle {cycle}, "
              f"round {rnd}, node {first['node']}")
        for order_name, (sq, rn) in first["sums"].items():
            thr = np.maximum(np.float32(faults.NORM_CLIP_MULT_SQ)
                             * np.float32(rn), np.float32(
                                 faults.NORM_CLIP_FLOOR_SQ))
            print(f"      {order_name:10s} sq {bits(sq)}, rn {bits(rn)}, "
                  f"threshold {bits(float(thr))}, sq > threshold: "
                  f"{np.float32(sq) > thr}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
