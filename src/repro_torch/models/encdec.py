"""Whisper-style encoder tower [arXiv:2212.04356].

Counterpart of ``repro/models/encdec.py``. The mel-spectrogram and conv
frontend is a stub, as in the reference: ``models/vision.py`` draws the
(B, source_len, d_model) frame embeddings it would give. The transformer
encoder (24 non-causal layers for whisper-medium) adds Whisper's fixed
sinusoidal positions to the frames; the decoder is the ``selfcross`` kind
of ``models/transformer.py``. ``params["blocks"]`` is a list of the
encoder's layers in order (the reference stacks them on a layer axis;
``convert.py`` moves them across).

Every encoder attention is the plain grouped attention (``impl="xla"``),
the reference's routing: its encoder passes no ``impl``, so kernel #8 is
never reached.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import AttentionConfig, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L


def _enc_attn_cfg(cfg: ModelConfig) -> AttentionConfig:
    a = cfg.attention
    return AttentionConfig(num_heads=a.num_heads, num_kv_heads=a.num_heads,
                           head_dim=a.head_dim, qk_norm=False,
                           use_rope=False, causal=False)


def encoder_layer_spec(cfg: ModelConfig) -> Dict:
    d = cfg.encoder.d_model or cfg.d_model
    return {
        "ln1": L.layernorm_spec(d, cfg.param_dtype),
        "attn": attn_mod.attention_spec(d, _enc_attn_cfg(cfg),
                                        cfg.param_dtype),
        "ln2": L.layernorm_spec(d, cfg.param_dtype),
        "ffn": L.mlp_spec(d, cfg.d_ff, "gelu", cfg.param_dtype),
    }


def encoder_spec(cfg: ModelConfig) -> Dict:
    return {
        "blocks": [encoder_layer_spec(cfg)
                   for _ in range(cfg.encoder.num_layers)],
        "final_ln": L.layernorm_spec(cfg.encoder.d_model or cfg.d_model,
                                     cfg.param_dtype),
    }


def sinusoids(length: int, channels: int, device=None):
    """Whisper's fixed sinusoidal position embedding (length, channels),
    float32."""
    log_timescale = (torch.log(torch.tensor(10_000.0, device=device))
                     / (channels // 2 - 1))
    inv = torch.exp(-log_timescale * torch.arange(
        channels // 2, dtype=torch.float32, device=device))
    ang = torch.arange(length, dtype=torch.float32,
                       device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def _encoder_layer(lp, cfg: ModelConfig, a: AttentionConfig, x):
    cd = cfg.compute_dtype
    h = L.layernorm(lp["ln1"], x, cfg.norm_eps)
    x = x + attn_mod.attention(lp["attn"], a, h, compute_dtype=cd,
                               impl="xla").to(x.dtype)
    h = L.layernorm(lp["ln2"], x, cfg.norm_eps)
    return x + L.mlp(lp["ffn"], h, "gelu").to(x.dtype)


def encoder_forward(params, cfg: ModelConfig, frames):
    """frames (B, source_len, d_model): the stub frontend's embeddings ->
    the encoder's output (B, source_len, d_model) in the compute dtype.
    Under ``remat`` with gradients on each layer is recomputed in the
    backward pass."""
    cd = cfg.compute_dtype
    x = frames.to(cd) + sinusoids(frames.shape[1], frames.shape[2],
                                  frames.device).to(cd)
    a = _enc_attn_cfg(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params["blocks"]:
        if remat:
            x = checkpoint(_encoder_layer, lp, cfg, a, x, use_reentrant=False)
        else:
            x = _encoder_layer(lp, cfg, a, x)
    return L.layernorm(params["final_ln"], x, cfg.norm_eps)


def encoder_cross_kv(params, cfg: ModelConfig, frames):
    """The decoder's cross K/V of every cross-attending layer from the
    encoder's output, the serve cache's ``ck``/``cv`` (so decode never
    runs the encoder): (ck, cv) each (layers, B, source_len, KV, hd), and
    the encoder's output."""
    enc = encoder_forward(params["encoder"], cfg, frames)
    ck, cv = [], []
    for lp in params["blocks"]:
        if "cross_attn" not in lp:
            continue
        k, v = attn_mod.project_kv(lp["cross_attn"], cfg.attention, enc)
        ck.append(k)
        cv.append(v)
    return torch.stack(ck), torch.stack(cv), enc
