"""End-to-end trainer: gossip-SGD or all-reduce on a transformer LM.

Counterpart of ``repro/launch/train.py``: the synthetic LM stream
(``data/lm_data.py``) -> the model's ``lm_loss`` -> the gossip or the
all-reduce step (``core/gossip_optimizer.py``) -> the loss and peer
disagreement, and checkpoints in the reference's format. The peers of the
gossip run are stacked on one device.

A vlm or audio model trains on the stub source the reference draws
(``models/vision.py``, threefry key ``seed + 1``): the same patch
embeddings or frames every step, one batch's worth under all-reduce, and
under gossip ``batch // n_peers`` of them broadcast across the peers.

Training runs the reference's default attention, ``attn_impl="chunked"``
(query chunks over the plain grouped attention, differentiable): the flash
kernel #8, the port's serving default, is forward only, as the reference's
Pallas kernel is. ``train`` sets it on the config.

Usage (on the card by default; ``--device cpu`` runs on the CPU):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --reduced --steps 200 --dist gossip --peers 4

  # a published config at its widths, the depth cut, int8 exchange
  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x22b \
      --full --layers 1 --steps 3 --dist gossip --peers 2 --optimizer sgdm \
      --exchange int8
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import random
from repro_torch.checkpoint import save_checkpoint
from repro_torch.config import GossipConfig, get_config, reduced_config
from repro_torch.convert import lm_params_to_reference
from repro_torch.core.gossip_optimizer import (GossipState,
                                               make_allreduce_train_step,
                                               make_gossip_train_step,
                                               peer_disagreement,
                                               perms_for_step,
                                               stack_for_peers, unstack_mean)
from repro_torch.data.lm_data import SyntheticLMDataset
from repro_torch.models import transformer as T
from repro_torch.models import vision as V
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map


def make_example_config(arch: str, reduced: bool, *, d_model: int = 0,
                        layers: int = 0):
    """The reduced config (d_model 256, 2 layers, vocab 2048 unless told),
    or the published one with its depth cut to ``layers`` where given."""
    cfg = get_config(arch)
    if reduced:
        cfg = reduced_config(cfg, d_model=d_model or 256, layers=layers or 2,
                             vocab=2048)
    elif layers:
        cfg = cfg.replace(num_layers=layers)
    return cfg


def train(arch: str = "qwen3-1.7b", *, reduced: bool = True, steps: int = 100,
          batch: int = 8, seq_len: int = 128, lr: float = 1e-3,
          dist: str = "allreduce", n_peers: int = 4, merge: str = "mu",
          schedule: str = "hypercube", optimizer: str = "adamw",
          seed: int = 0, log_every: int = 10, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 0, d_model: int = 0, layers: int = 0,
          exchange_dtype: str = "", device=None):
    """Train ``steps`` steps; returns ``(final_params, history)``: the
    final parameters (the peers' float32 mean under gossip) as a tree in
    the port's layout, and ``(step, loss, peer_disagreement)`` at every
    ``log_every`` steps and the last (disagreement 0.0 under all-reduce).
    ``device``: the CUDA card when None (raises without one); ``"cpu"``
    runs on the CPU. The weights are drawn from a generator seeded with
    ``seed`` on that device. ``layers`` cuts a published config's depth
    (``reduced=False``); ``exchange_dtype`` is the gossip exchange's wire
    codec (``GossipConfig.exchange_dtype``: "" sends the parameters as
    they are)."""
    device = resolve_device(device)
    cfg = make_example_config(arch, reduced, d_model=d_model, layers=layers)
    cfg = cfg.replace(attn_impl="chunked")
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"dist={dist}" + (f" peers={n_peers} merge={merge}"
                            if dist == "gossip" else "") + f" on {device}")

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = tree_map(lambda p: p.detach(), T.init_params(cfg, gen, device))
    sched = warmup_cosine(lr, min(20, steps // 5 + 1), steps)
    opt = make_optimizer(optimizer, sched)
    ds = SyntheticLMDataset(cfg.vocab_size, seq_len, batch, seed=seed)

    # the stub source beside the tokens (vlm, audio), the same every step:
    # batch rows, or batch // n_peers broadcast over the peers
    draw = {"vlm": V.dummy_patch_embeddings,
            "audio": V.dummy_frame_embeddings}.get(cfg.family)
    source = None
    if draw is not None:
        source = draw(random.key(seed + 1, device), cfg,
                      batch // n_peers if dist == "gossip" else batch)
        if dist == "gossip":
            source = source[None].expand((n_peers,) + source.shape)

    def loss_fn(p, b):
        return T.lm_loss(p, cfg, b["tokens"], b["labels"],
                         encoder_out=b.get("encoder_out"))

    def upload(raw, shape):
        b = {k: torch.as_tensor(v, device=device).reshape(shape)
             for k, v in raw.items()}
        if source is not None:
            b["encoder_out"] = source
        return b

    history = []
    t0 = time.time()
    if dist == "gossip":
        if batch % n_peers:
            raise ValueError(f"batch {batch} does not split over {n_peers} "
                             "peers")
        gcfg = GossipConfig(schedule=schedule, merge=merge,
                            exchange_dtype=exchange_dtype)
        sp = stack_for_peers(params, n_peers)
        del params
        state = GossipState(sp, opt.init(sp),
                            torch.zeros((), dtype=torch.int32, device=device))
        step_fn = make_gossip_train_step(loss_fn, opt, n_peers, gcfg)
        for s in range(steps):
            b = upload(next(ds), (n_peers, batch // n_peers, seq_len))
            perm, _ = perms_for_step(gcfg, s, n_peers)
            state, loss, _ = step_fn(state, b, perm, None)
            if (s + 1) % log_every == 0 or s == steps - 1:
                dis = float(peer_disagreement(state.params))
                print(f"step {s+1:5d}  loss {float(loss):.4f}  "
                      f"peer-disagreement {dis:.2e}  "
                      f"({(time.time()-t0)/(s+1):.2f}s/step)")
                history.append((s + 1, float(loss), dis))
            if ckpt_dir and ckpt_every and (s + 1) % ckpt_every == 0:
                save_checkpoint(ckpt_dir, s + 1, {"params": (
                    lm_params_to_reference(cfg, unstack_mean(state.params)))})
        final_params = unstack_mean(state.params)
    elif dist == "allreduce":
        step_fn = make_allreduce_train_step(loss_fn, opt)
        opt_state = opt.init(params)
        step_idx = torch.zeros((), dtype=torch.int32, device=device)
        for s in range(steps):
            b = upload(next(ds), (batch, seq_len))
            params, opt_state, loss, _ = step_fn(params, opt_state, b,
                                                 step_idx)
            step_idx = step_idx + 1
            if (s + 1) % log_every == 0 or s == steps - 1:
                print(f"step {s+1:5d}  loss {float(loss):.4f}  "
                      f"({(time.time()-t0)/(s+1):.2f}s/step)")
                history.append((s + 1, float(loss), 0.0))
            if ckpt_dir and ckpt_every and (s + 1) % ckpt_every == 0:
                save_checkpoint(ckpt_dir, s + 1, {
                    "params": lm_params_to_reference(cfg, params)})
        final_params = params
    else:
        raise ValueError(f"unknown dist {dist!r} (allreduce or gossip)")
    return final_params, history


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen3-1.7b")
    p.add_argument("--reduced", action="store_true", default=True)
    p.add_argument("--full", dest="reduced", action="store_false")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--dist", default="allreduce",
                   choices=["allreduce", "gossip"])
    p.add_argument("--peers", type=int, default=4)
    p.add_argument("--merge", default="mu", choices=["mu", "um", "rw"])
    p.add_argument("--schedule", default="hypercube")
    p.add_argument("--optimizer", default="adamw")
    p.add_argument("--exchange", default="",
                   help="the gossip exchange's wire codec (bf16, int8, "
                        "int4, ...); the parameters as they are if empty")
    p.add_argument("--d-model", type=int, default=0)
    p.add_argument("--layers", type=int, default=0)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="the CUDA card when not given; 'cpu' for the CPU")
    a = p.parse_args()
    train(a.arch, reduced=a.reduced, steps=a.steps, batch=a.batch,
          seq_len=a.seq_len, lr=a.lr, dist=a.dist, n_peers=a.peers,
          merge=a.merge, schedule=a.schedule, optimizer=a.optimizer,
          seed=a.seed, ckpt_dir=a.ckpt_dir, ckpt_every=a.ckpt_every,
          d_model=a.d_model, layers=a.layers, exchange_dtype=a.exchange,
          device=a.device)


if __name__ == "__main__":
    main()
