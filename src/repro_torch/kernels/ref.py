"""Plain PyTorch oracles of the population kernels and of attention.

Counterpart of ``repro/kernels/ref.py``. ``pegasos_update_ref`` and
``merge_update_ref`` are the plain versions of kernels #6 and #7
(``pegasos_update.py``, ``gossip_merge.py``) and of the receive kernel's
Pegasos step; ``attention_ref`` is masked softmax attention with the
decode alignment (``Sk >= Sq``), the reference the flash kernel's own plain
version (``flash_attention.flash_attention_plain``) agrees with at
``Sq = Sk``.
"""
from __future__ import annotations

import math

import torch


def pegasos_update_ref(w, t, x, y, lam: float):
    """Population Pegasos step in f32. w, x: (N, d); t: (N,) int32; y:
    (N,) ±1. Returns (w', t')."""
    t_new = t + 1
    eta = 1.0 / (lam * t_new.to(torch.float32))
    margin = y * torch.sum(w * x, dim=-1)
    decay = (1.0 - eta * lam)[:, None]
    upd = torch.where((margin < 1.0)[:, None], (eta * y)[:, None] * x, 0.0)
    return decay * w + upd, t_new


def merge_update_ref(w1, t1, w2, t2, x, y, lam: float):
    """The MU step: the Pegasos step of merge((w1, t1), (w2, t2))."""
    return pegasos_update_ref((w1 + w2) / 2.0, torch.maximum(t1, t2), x, y,
                              lam)


def attention_ref(q, k, v, *, causal: bool = True, window=None, scale=None):
    """Masked softmax attention with grouped-query heads. q: (B, Sq, H,
    hd); k, v: (B, Sk, KV, hd) with H % KV == 0; the last Sq keys align
    with the queries. Returns (B, Sq, H, hd) in q's dtype; softmax in
    f32."""
    _, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    k = torch.repeat_interleave(k, h // kv, dim=2)
    v = torch.repeat_interleave(v, h // kv, dim=2)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqhk,bshk->bhqs", q.float(), k.float()) * scale
    diff = (torch.arange(sq, device=q.device)[:, None] + (sk - sq)
            - torch.arange(sk, device=q.device)[None, :])
    mask = torch.ones_like(diff, dtype=torch.bool)
    if causal:
        mask &= diff >= 0
    if window is not None:
        mask &= diff < window
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqs,bshk->bqhk", probs, v.float()).to(q.dtype)
