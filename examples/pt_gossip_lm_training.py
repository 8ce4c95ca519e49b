"""Gossip-SGD against all-reduce on a transformer LM, on the PyTorch/CUDA
port.

The port's counterpart of ``examples/gossip_lm_training.py``: the paper's
protocol used as a training primitive. Each data-parallel replica is a
*peer*; instead of all-reducing gradients every step, a replica takes a
local AdamW step and averages parameters with ONE partner per step
(CREATEMODELMU with a hypercube partner schedule). The script trains the
same model both ways on the same synthetic LM stream and prints the loss
and the peer disagreement, so the merge's consensus is visible. The peers
are stacked on one device.

    PYTHONPATH=src python examples/pt_gossip_lm_training.py --steps 60
    PYTHONPATH=src python examples/pt_gossip_lm_training.py --size 100m --steps 300
    PYTHONPATH=src python examples/pt_gossip_lm_training.py --device cpu

It runs on the CUDA card unless ``--device`` names another.
"""
from __future__ import annotations

import argparse

from repro_torch.launch.train import train

SIZES = {
    # d_model, layers  (vocab 2048, qwen3 family: GQA + qk-norm + SwiGLU)
    "tiny": (256, 2),      # ~ 5M params
    "20m": (512, 4),       # ~20M
    "100m": (1024, 8),     # ~105M
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="tiny", choices=sorted(SIZES))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--peers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--merge", default="mu", choices=["mu", "um", "rw"])
    ap.add_argument("--schedule", default="hypercube",
                    choices=["hypercube", "ring", "random"])
    ap.add_argument("--skip-allreduce", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    d_model, layers = SIZES[args.size]

    print("=== gossip (one partner's model exchanged per step) ===")
    _, hist_g = train("qwen3-1.7b", reduced=True, steps=args.steps,
                      batch=args.batch, seq_len=args.seq_len, dist="gossip",
                      n_peers=args.peers, merge=args.merge,
                      schedule=args.schedule, d_model=d_model, layers=layers,
                      device=args.device)

    if not args.skip_allreduce:
        print("\n=== all-reduce baseline (conventional DP) ===")
        _, hist_a = train("qwen3-1.7b", reduced=True, steps=args.steps,
                          batch=args.batch, seq_len=args.seq_len,
                          dist="allreduce", d_model=d_model, layers=layers,
                          device=args.device)
        print("\nstep   gossip-loss  allreduce-loss  peer-disagreement")
        for (s, lg, dis), (_, la, _) in zip(hist_g, hist_a):
            print(f"{s:5d}  {lg:11.4f}  {la:14.4f}  {dis:.3e}")


if __name__ == "__main__":
    main()
