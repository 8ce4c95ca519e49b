"""Model assembler: spec, forward, fused prefill and decode for the dense,
moe, ssm and hybrid families.

Counterpart of ``repro/models/transformer.py`` for the layer kinds
``"attn"`` (global, or config-windowed, self-attention + FFN), ``"local"``
(sliding-window self-attention, window ``rglru.local_window``, + FFN),
``"ssm"`` (the Mamba-2 SSD mixer, ``models/ssm.py``; no FFN when
``d_ff == 0``) and ``"rglru"`` (the RG-LRU mixer, ``models/rglru.py``, +
FFN); with ``cfg.moe`` every FFN is the MoE FFN (``models/moe.py``),
whose load-balance loss the forward sums over the layers as the aux loss.
The reference stacks each pattern position's layers and scans over them;
here ``params["blocks"]`` is an ``nn.ModuleList`` of the ``num_layers``
layers in order (kinds from ``cfg.layer_kinds()``), walked in a Python
loop, and a decode cache is a list of per-layer dicts in the same order:
``{"k", "v"}`` for an attention layer, ``{"ssm", "conv"}`` and ``{"h",
"conv"}`` for the recurrent ones. Decode updates every entry in place.
The forward also takes a plain tree of tensors in that layout (nested
dicts, ``"blocks"`` a list), as the training step passes one peer's
parameters with gradients on. ``scan_layers`` means nothing here; under
``remat`` each layer is recomputed in the backward pass when gradients
are on (the reference's ``jax.checkpoint`` of its block), and the
reference's ``shard_activations`` is the identity outside a mesh.
:func:`lm_loss` is the training loss.

The cross and selfcross kinds, the encoder and the learned positions of
the vlm and audio families are not ported yet (ROADMAP queue 1 item 12b):
building a spec for them raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import P
from repro_torch.utils.device import resolve_device

KINDS = ("attn", "local", "ssm", "rglru")
ATTENTION_KINDS = ("attn", "local")


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               "(ROADMAP.md, queue 1 item 12b)")


def _check_supported(cfg: ModelConfig):
    for kind in cfg.layer_kinds():
        if kind not in KINDS:
            raise _not_ported(f"layer kind {kind!r}")
    for field in ("encoder", "cross_attn"):
        if getattr(cfg, field) is not None:
            raise _not_ported(f"{field} ({cfg.name})")
    if cfg.max_target_positions:
        raise _not_ported(f"learned positions ({cfg.name})")


# ---------------------------------------------------------------------------
# spec construction
# ---------------------------------------------------------------------------


def _norm_spec(cfg: ModelConfig):
    return (L.layernorm_spec if cfg.norm == "layernorm" else L.rmsnorm_spec)(
        cfg.d_model, cfg.param_dtype)


def _apply_norm(cfg: ModelConfig, params, x):
    if cfg.norm == "layernorm":
        return L.layernorm(params, x, cfg.norm_eps)
    return L.rmsnorm(params, x, cfg.norm_eps)


def _attn_cfg(cfg: ModelConfig, kind: str):
    a = cfg.attention
    if kind == "local":
        a = dataclasses.replace(a, sliding_window=cfg.rglru.local_window
                                if cfg.rglru else a.sliding_window)
    return a


def _ffn_spec(cfg: ModelConfig):
    if cfg.moe is not None:
        return moe_mod.moe_spec(cfg.d_model, cfg.moe, cfg.act,
                                cfg.param_dtype)
    if cfg.d_ff == 0:
        return None
    return L.mlp_spec(cfg.d_model, cfg.d_ff, cfg.act, cfg.param_dtype)


def layer_spec(cfg: ModelConfig, kind: str) -> Dict:
    if kind not in KINDS:
        raise _not_ported(f"layer kind {kind!r}")
    s: Dict[str, Any] = {"ln1": _norm_spec(cfg)}
    if kind in ATTENTION_KINDS:
        s["attn"] = attn_mod.attention_spec(cfg.d_model, _attn_cfg(cfg, kind),
                                            cfg.param_dtype)
    elif kind == "ssm":
        s["ssm"] = ssm_mod.ssm_spec(cfg.d_model, cfg.ssm, cfg.param_dtype)
    else:
        s["rglru"] = rglru_mod.rglru_spec(cfg.d_model, cfg.rglru,
                                          cfg.param_dtype)
    ffn = _ffn_spec(cfg)
    if ffn is not None:
        s["ln2"] = _norm_spec(cfg)
        s["ffn"] = ffn
    return s


def model_spec(cfg: ModelConfig) -> Dict:
    """The parameter spec: embedding, the layers in order, final norm and
    (untied) head."""
    _check_supported(cfg)
    spec: Dict[str, Any] = {
        "embed": L.embedding_spec(cfg.vocab_size, cfg.d_model,
                                  cfg.param_dtype),
        "final_norm": _norm_spec(cfg),
        "blocks": [layer_spec(cfg, kind) for kind in cfg.layer_kinds()],
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = {"w": P((cfg.d_model, cfg.vocab_size),
                                  init="fan_in", dtype=cfg.param_dtype)}
    return spec


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None, seed: int = 0) -> L.Params:
    """Random parameters on ``device`` (the CUDA card unless told
    otherwise), drawn from ``generator``, or from a new one seeded with
    ``seed``, on that device."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    return L.init_params(model_spec(cfg), generator, device)


# ---------------------------------------------------------------------------
# forward and fused prefill
# ---------------------------------------------------------------------------


def _kv_to_cache(k, v, length: int, dtype):
    """Place prompt K/V rows into a (B, L, KV, hd) decode cache at the
    ring slots ``pos % L`` (the identity when the prompt fits)."""
    p = k.shape[1]
    lo = max(0, p - length)
    slots = torch.arange(lo, p, device=k.device) % length
    ck = torch.zeros((k.shape[0], length) + k.shape[2:], dtype=dtype,
                     device=k.device)
    cv = torch.zeros_like(ck)
    ck[:, slots] = k[:, lo:].to(dtype)
    cv[:, slots] = v[:, lo:].to(dtype)
    return ck, cv


def _cache_len(cfg: ModelConfig, kind: str, length: int,
               window: Optional[int]) -> int:
    """A layer's decode-cache slots: ``length``, cut to the serve
    ``window`` and to the layer's sliding window."""
    eff = min(length, window) if window else length
    sw = _attn_cfg(cfg, kind).sliding_window
    return min(eff, sw) if sw else eff


def _ffn(lp, cfg: ModelConfig, x):
    """The layer's FFN on its normed input: (out, the MoE's load-balance
    loss or None)."""
    if cfg.moe is not None:
        out, aux = moe_mod.moe_ffn(lp["ffn"], cfg.moe, x, cfg.act)
        return out, aux["load_balance_loss"]
    return L.mlp(lp["ffn"], x, cfg.act), None


def _apply_layer(lp, kind: str, cfg: ModelConfig, x, *, positions, aux,
                 cache_len: Optional[int] = None,
                 window: Optional[int] = None):
    """One layer: (x, aux plus the layer's MoE loss). With ``cache_len``
    (fused prefill) also the layer's decode-cache entry."""
    cd = cfg.compute_dtype
    h = _apply_norm(cfg, lp["ln1"], x)
    want_state = cache_len is not None
    entry = None
    if kind in ATTENTION_KINDS:
        mix = attn_mod.attention(lp["attn"], _attn_cfg(cfg, kind), h,
                                 positions=positions, compute_dtype=cd,
                                 impl=cfg.attn_impl,
                                 attn_chunk=cfg.attn_chunk,
                                 return_kv=want_state)
        if want_state:
            mix, (k, v) = mix
            ck, cv = _kv_to_cache(k, v,
                                  _cache_len(cfg, kind, cache_len, window),
                                  cd)
            entry = {"k": ck, "v": cv}
    else:
        if kind == "ssm":
            mix = ssm_mod.ssm_forward(lp["ssm"], cfg.ssm, cfg.d_model, h,
                                      compute_dtype=cd,
                                      return_state=want_state)
        else:
            mix = rglru_mod.rglru_forward(lp["rglru"], cfg.rglru,
                                          cfg.d_model, h, compute_dtype=cd,
                                          return_state=want_state)
        if want_state:
            mix, entry = mix
    x = x + mix.to(x.dtype)
    if "ffn" in lp:
        out, lb = _ffn(lp, cfg, _apply_norm(cfg, lp["ln2"], x))
        if lb is not None:
            aux = aux + lb
        x = x + out.to(x.dtype)
    if want_state:
        return x, aux, entry
    return x, aux


def forward_hidden(params, cfg: ModelConfig, tokens, *, positions=None):
    """tokens (B, S) -> final hidden states (B, S, d_model) and the aux
    loss (float32: the layers' MoE load-balance losses summed in layer
    order, zero without MoE). ``params``: a ``Params`` or a tree of
    tensors in its layout."""
    b, s = tokens.shape
    x = L.embed(params["embed"], tokens, cfg.compute_dtype)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, kind in zip(params["blocks"], cfg.layer_kinds()):
        if remat:
            x, aux = checkpoint(_remat_layer, lp, kind, cfg, x, positions,
                                aux, use_reentrant=False)
        else:
            x, aux = _apply_layer(lp, kind, cfg, x, positions=positions,
                                  aux=aux)
    x = _apply_norm(cfg, params["final_norm"], x)
    return x, aux


def _remat_layer(lp, kind, cfg, x, positions, aux):
    return _apply_layer(lp, kind, cfg, x, positions=positions, aux=aux)


def lm_loss(params, cfg: ModelConfig, tokens, labels, *, seq_chunk: int = 0):
    """Mean next-token cross-entropy plus the MoE aux loss (zero without
    MoE), computed in sequence chunks of ``seq_chunk`` (default
    ``cfg.xent_chunk``). A chunk's (B, chunk, vocab) float32 logits are the
    only vocab-sized temporary and are recomputed in the backward pass, so
    the whole (B, S, vocab) logits never exist. Returns ``(loss, {"nll",
    "aux"})``."""
    x, aux = forward_hidden(params, cfg, tokens)
    w = _head_matrix(params, cfg)
    b, s, _ = x.shape
    chunk = min(seq_chunk or cfg.xent_chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the loss "
                         f"chunk {chunk}")
    labels = labels.long()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        total = total + checkpoint(_xent_sum, x[:, c0:c0 + chunk], w,
                                   labels[:, c0:c0 + chunk],
                                   use_reentrant=False)
    nll = total / (b * s)
    return nll + aux, {"nll": nll, "aux": aux}


def _xent_sum(x, w, labels):
    """Summed cross-entropy of one chunk: logsumexp minus the gold logit,
    the logits in float32."""
    logits = x.float() @ w.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.sum(logz - gold)


def _head_matrix(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["lm_head"]["w"]


def forward(params, cfg: ModelConfig, tokens, *, positions=None,
            last_only: bool = False):
    """tokens (B, S) -> f32 logits (B, S, vocab), or (B, vocab) at the
    last position with ``last_only``, and the aux loss."""
    x, aux = forward_hidden(params, cfg, tokens, positions=positions)
    if last_only:
        x = x[:, -1:]
    logits = x.float() @ _head_matrix(params, cfg).float()
    return (logits[:, 0] if last_only else logits), aux


def prefill(params, cfg: ModelConfig, tokens, cache_len: int, *,
            window: Optional[int] = None):
    """Fused prefill: one full-sequence pass that also emits the decode
    cache (KV rows at their ring slots, the recurrent layers' states after
    the last position), the same as feeding the prompt token by token
    through ``decode_step``. tokens: (B, P). Returns the last position's
    f32 logits (B, vocab) and the cache (as ``init_cache`` makes it).
    A serve ``window`` narrows the global attention layers' window; a
    ``local`` layer keeps its own, as in the reference."""
    if window is not None and cfg.attention is not None:
        # a ring cache of `window` slots is windowed attention: the fused
        # pass must not see keys the sequential path has evicted
        sw = cfg.attention.sliding_window
        cfg = cfg.replace(attention=dataclasses.replace(
            cfg.attention, sliding_window=min(sw, window) if sw else window))
    b, p = tokens.shape
    x = L.embed(params["embed"], tokens, cfg.compute_dtype)
    positions = torch.arange(p, dtype=torch.int32,
                             device=x.device)[None].expand(b, p)
    cache: List[Dict[str, torch.Tensor]] = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, kind in zip(params["blocks"], cfg.layer_kinds()):
        x, aux, entry = _apply_layer(lp, kind, cfg, x, positions=positions,
                                     aux=aux, cache_len=cache_len,
                                     window=window)
        cache.append(entry)
    x = _apply_norm(cfg, params["final_norm"], x[:, -1:])
    logits = x.float() @ _head_matrix(params, cfg).float()
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, length: int,
                 window: Optional[int], device):
    """One layer's zero decode-cache entry (the reference's
    ``_layer_cache_spec``)."""
    cd = cfg.compute_dtype
    if kind in ATTENTION_KINDS:
        return attn_mod.init_kv_cache(batch,
                                      _cache_len(cfg, kind, length, window),
                                      _attn_cfg(cfg, kind), cd, device)
    if kind == "ssm":
        return ssm_mod.init_ssm_state(batch, cfg.d_model, cfg.ssm, cd, device)
    return rglru_mod.init_rglru_state(batch, cfg.d_model, cfg.rglru, cd,
                                      device)


def init_cache(cfg: ModelConfig, batch: int, length: int,
               window: Optional[int] = None, device=None):
    """The zero decode cache on ``device`` (the CUDA card unless told
    otherwise): a layer's entry is ``{"k", "v"}`` of (B, slots, KV, hd) in
    the compute dtype for attention, ``{"ssm", "conv"}`` for an ssm layer
    and ``{"h", "conv"}`` for an rglru layer (float32 states, the conv
    windows in the compute dtype)."""
    _check_supported(cfg)
    device = resolve_device(device)
    return [_layer_cache(cfg, kind, batch, length, window, device)
            for kind in cfg.layer_kinds()]


def _apply_layer_decode(lp, lc, kind: str, cfg: ModelConfig, x, index: int):
    cd = cfg.compute_dtype
    h = _apply_norm(cfg, lp["ln1"], x)
    if kind in ATTENTION_KINDS:
        # the cache is addressed as a ring: when its length covers the
        # whole sequence this is linear addressing
        mix, lc = attn_mod.decode_attention(lp["attn"], _attn_cfg(cfg, kind),
                                            h, lc, index, compute_dtype=cd,
                                            window=lc["k"].shape[1])
    else:
        if kind == "ssm":
            mix, new = ssm_mod.ssm_step(lp["ssm"], cfg.ssm, cfg.d_model, h,
                                        lc, compute_dtype=cd)
        else:
            mix, new = rglru_mod.rglru_step(lp["rglru"], cfg.rglru,
                                            cfg.d_model, h, lc,
                                            compute_dtype=cd)
        for name, t in new.items():
            lc[name].copy_(t)
    x = x + mix.to(x.dtype)
    if "ffn" in lp:
        out, _ = _ffn(lp, cfg, _apply_norm(cfg, lp["ln2"], x))
        x = x + out.to(x.dtype)
    return x, lc


def decode_step(params, cfg: ModelConfig, token, cache, index: int):
    """One decode step: token (B,), ``cache`` from ``init_cache`` or
    ``prefill`` (updated in place), ``index`` the token's absolute
    position. Returns (f32 logits (B, vocab), cache)."""
    x = L.embed(params["embed"], token[:, None], cfg.compute_dtype)
    for i, (lp, kind) in enumerate(zip(params["blocks"], cfg.layer_kinds())):
        x, cache[i] = _apply_layer_decode(lp, cache[i], kind, cfg, x, index)
    x = _apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = L.unembed(params["embed"], x)
    else:
        logits = x.float() @ params["lm_head"]["w"].float()
    return logits[:, 0], cache
