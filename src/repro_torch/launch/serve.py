"""Batched decode server for the LM stack.

Counterpart of ``repro/launch/serve.py``. Serves a batch of token prompts:
the prompts are prefilled into the cache (KV rows for attention layers,
the recurrent states of ssm and rglru layers), then decoded greedily one
token per step for the whole batch. Prefill is fused by default (one
full-sequence forward that emits the cache, every attention layer on the
flash kernel #8 on the card); ``fused_prefill=False`` feeds the prompt
through ``decode_step`` token by token. The cache stays on the parameters'
device and is updated in place. A serve ``window`` makes the attention
layers' caches rings of that many slots; the recurrent states are O(1)
and take no window. Serves every registered config: dense (the qwen3
configs, llama3-405b), moe
(mixtral-8x22b, llama4-scout-17b-a16e), ssm (mamba2-780m), hybrid
(recurrentgemma-9b), vlm (llama-3.2-vision-11b) and audio
(whisper-medium). A vlm or audio server draws its stub source from
threefry key 0 as the reference's does (``models/vision.py``): the patch
embeddings, or the frames, which the encoder runs on once to fill the
cross K/V of the token-by-token path, while the fused prefill runs the
encoder itself.

Usage (on the card; ``--reduced`` shrinks the model, ``--device cpu`` runs
on the CPU; ``--layers`` cuts the depth at full width):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --batch 4 --prompt-len 32 --decode-steps 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \
      --layers 4 --batch 2 --prompt-len 512 --max-len 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-405b \
      --layers 4 --batch 2 --prompt-len 2048 --max-len 4096
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import random
from repro_torch.config import get_config, reduced_config
from repro_torch.models import attention as attn_mod
from repro_torch.models import encdec
from repro_torch.models import transformer as T
from repro_torch.models import vision as V
from repro_torch.utils.device import resolve_device


class DecodeServer:
    """Holds the parameters and the decode cache; serves one batch of
    prompts at a time."""

    def __init__(self, cfg, params, *, batch: int, max_len: int,
                 window: Optional[int] = None, fused_prefill: bool = True):
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.window = window
        self.fused_prefill = fused_prefill
        self.device = params["embed"]["table"].device
        self.cache = T.init_cache(cfg, batch, max_len, window,
                                  device=self.device)
        self._src = None
        if cfg.family in ("vlm", "audio"):
            self._attach_cross_kv()

    def _attach_cross_kv(self):
        """Fill the cross layers' ``ck``/``cv`` from the stub source drawn
        from key 0: the patch embeddings themselves (vlm), or the encoder's
        output on the frames (audio), whose raw frames are kept for the
        fused prefill, which runs the encoder itself."""
        cfg = self.cfg
        key = random.key(0, self.device)
        if cfg.family == "vlm":
            src = self._src = V.dummy_patch_embeddings(key, cfg, self.batch)
        else:
            self._src = V.dummy_frame_embeddings(key, cfg, self.batch)
            src = encdec.encoder_forward(self.params["encoder"], cfg,
                                         self._src)
        for lp, lc in zip(self.params["blocks"], self.cache):
            if "ck" in lc:
                k, v = attn_mod.project_kv(lp["cross_attn"], cfg.attention,
                                           src)
                lc["ck"].copy_(k)
                lc["cv"].copy_(v)

    def prefill(self, prompts):
        """prompts: (batch, prompt_len) integer array or tensor. Fills the
        cache; returns the last position's f32 logits (batch, vocab) and
        the prompt length."""
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                               device=self.device)
        if toks.shape[0] != self.batch:
            raise ValueError(f"expected {self.batch} prompts, got "
                             f"{toks.shape[0]}")
        if self.fused_prefill:
            logits, self.cache = T.prefill(self.params, self.cfg, toks,
                                           self.max_len,
                                           encoder_out=self._src,
                                           window=self.window)
            return logits, toks.shape[1]
        logits = None
        for i in range(toks.shape[1]):
            logits, self.cache = T.decode_step(self.params, self.cfg,
                                               toks[:, i], self.cache, i)
        return logits, toks.shape[1]

    def decode(self, first_logits, start: int, steps: int) -> np.ndarray:
        """Greedy continuation for the whole batch: ``steps`` tokens from
        position ``start``. Returns (batch, steps) int64."""
        out = []
        logits = first_logits
        for s in range(steps):
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
            logits, self.cache = T.decode_step(self.params, self.cfg, tok,
                                               self.cache, start + s)
        return torch.stack(out, dim=1).cpu().numpy()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="qwen3-1.7b")
    p.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                   default=False, help="serve the reduced (CPU-size) config")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--decode-steps", type=int, default=32)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--window", type=int, default=0)
    p.add_argument("--layers", type=int, default=0,
                   help="cut the depth to this many layers (0: the "
                   "config's)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (raises without one)")
    a = p.parse_args(argv)

    device = resolve_device(a.device)
    cfg = get_config(a.arch)
    if a.reduced:
        cfg = reduced_config(cfg, vocab=2048)
    if a.layers:
        cfg = cfg.replace(num_layers=a.layers)
    params = T.init_params(cfg, device=device, seed=a.seed)
    srv = DecodeServer(cfg, params, batch=a.batch, max_len=a.max_len,
                       window=a.window or None)
    rng = np.random.default_rng(a.seed)
    prompts = rng.integers(0, cfg.vocab_size, (a.batch, a.prompt_len))
    _sync(device)
    t0 = time.perf_counter()
    logits, start = srv.prefill(prompts)
    _sync(device)
    t1 = time.perf_counter()
    toks = srv.decode(logits, start, a.decode_steps)
    t2 = time.perf_counter()
    print(f"arch={cfg.name} device={device} batch={a.batch} prefill "
          f"{a.prompt_len} tok in {t1 - t0:.3f}s; decoded {a.decode_steps} "
          f"tok in {t2 - t1:.3f}s "
          f"({a.decode_steps * a.batch / (t2 - t1):.1f} tok/s)")
    print("sample continuation:", toks[0][:16].tolist())


if __name__ == "__main__":
    main()
