"""Model assembler: spec, forward, fused prefill and decode for every
family of the reference: dense, moe, ssm, hybrid, vlm and audio.

Counterpart of ``repro/models/transformer.py`` for the layer kinds
``"attn"`` (global, or config-windowed, self-attention + FFN), ``"local"``
(sliding-window self-attention, window ``rglru.local_window``, + FFN),
``"ssm"`` (the Mamba-2 SSD mixer, ``models/ssm.py``; no FFN when
``d_ff == 0``), ``"rglru"`` (the RG-LRU mixer, ``models/rglru.py``, +
FFN), ``"cross"`` (Llama-3.2-Vision's gated cross-attention to the patch
embeddings + FFN, each scaled by ``tanh`` of a float32 scalar gate that
starts at zero) and ``"selfcross"`` (Whisper's decoder layer:
self-attention, cross-attention to the encoder's output, FFN); with
``cfg.moe`` every FFN is the MoE FFN (``models/moe.py``), whose
load-balance loss the forward sums over the layers as the aux loss. With
``cfg.encoder`` the spec holds the encoder tower (``models/encdec.py``),
which the forward and the prefill run on the frames passed as
``encoder_out``; a vlm's ``encoder_out`` is the patch embeddings
themselves. With ``cfg.max_target_positions`` a learned position table
(``pos_embed``) is added to the embeddings, positions past its end
clamped to its last row, as in the reference.

Only ``"attn"`` and ``"local"`` layers take ``cfg.attn_impl`` (kernel #8
under ``"flash"``); cross-attention, and the selfcross kind's
self-attention, run the plain grouped attention, the reference's routing.
The reference stacks each pattern position's layers and scans over them;
here ``params["blocks"]`` is an ``nn.ModuleList`` of the ``num_layers``
layers in order (kinds from ``cfg.layer_kinds()``), walked in a Python
loop, and a decode cache is a list of per-layer dicts in the same order:
``{"k", "v"}`` for an attention layer, ``{"ssm", "conv"}`` and ``{"h",
"conv"}`` for the recurrent ones, ``{"ck", "cv"}`` (the source's keys and
values) for a cross layer and both for a selfcross layer, whose self K/V
has at most ``max_target_positions`` slots. Decode updates every entry in
place. The forward also takes a plain tree of tensors in that layout
(nested dicts, ``"blocks"`` a list), as the training step passes one
peer's parameters with gradients on. ``scan_layers`` means nothing here;
under ``remat`` each layer is recomputed in the backward pass when
gradients are on (the reference's ``jax.checkpoint`` of its block).
:func:`lm_loss` is the training loss.

Under a mesh (``launch/specs.py``'s step builders) the parameters and
the inputs are DTensors, and the forward constrains the activations where
the reference does (``sharding/act.py``): the embeddings and each
pattern period's output batch-sharded, the logits vocab-sharded. A
decode-cache write lands in the shard that holds its slot
(``act.write_into``); the fused prefill places its K/V rows in a per-rank
body.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import encdec
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import P
from repro_torch.sharding import act
from repro_torch.sharding.act import shard_activations, shard_logits
from repro_torch.utils.device import resolve_device

KINDS = ("attn", "local", "ssm", "rglru", "cross", "selfcross")
# the kinds whose self-attention takes cfg.attn_impl (kernel #8 on "flash")
ATTENTION_KINDS = ("attn", "local")


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
        raise ValueError(f"unknown layer kind {kind!r}")
    s: Dict[str, Any] = {"ln1": _norm_spec(cfg)}
    if kind in ATTENTION_KINDS + ("selfcross",):
        s["attn"] = attn_mod.attention_spec(cfg.d_model, _attn_cfg(cfg, kind),
                                            cfg.param_dtype)
    elif kind == "ssm":
        s["ssm"] = ssm_mod.ssm_spec(cfg.d_model, cfg.ssm, cfg.param_dtype)
    elif kind == "rglru":
        s["rglru"] = rglru_mod.rglru_spec(cfg.d_model, cfg.rglru,
                                          cfg.param_dtype)
    else:
        s["cross_attn"] = attn_mod.attention_spec(
            cfg.d_model, cfg.attention, cfg.param_dtype)
        if cfg.cross_attn and cfg.cross_attn.gated:
            s["gate_attn"] = P((), (), init="zeros", dtype=torch.float32)
            s["gate_ffn"] = P((), (), init="zeros", dtype=torch.float32)
    if kind == "selfcross":
        s["lnx"] = _norm_spec(cfg)
        s["cross_attn"] = attn_mod.attention_spec(
            cfg.d_model, cfg.attention, cfg.param_dtype)
    ffn = _ffn_spec(cfg)
    if ffn is not None:
        s["ln2"] = _norm_spec(cfg)
        s["ffn"] = ffn
    return s


def model_spec(cfg: ModelConfig) -> Dict:
    """The parameter spec: embedding, the layers in order, final norm,
    (untied) head, learned positions and the encoder tower."""
    spec: Dict[str, Any] = {
        "embed": L.embedding_spec(cfg.vocab_size, cfg.d_model,
                                  cfg.param_dtype),
        "final_norm": _norm_spec(cfg),
        "blocks": [layer_spec(cfg, kind) for kind in cfg.layer_kinds()],
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = {"w": P((cfg.d_model, cfg.vocab_size),
                                  ("embed_table", "vocab"), init="fan_in",
                                  dtype=cfg.param_dtype)}
    if cfg.max_target_positions:
        spec["pos_embed"] = L.positional_embedding_spec(
            cfg.max_target_positions, cfg.d_model, cfg.param_dtype)
    if cfg.encoder is not None:
        spec["encoder"] = encdec.encoder_spec(cfg)
    return spec


def param_axes(cfg: ModelConfig):
    """The logical-axes tree of the parameters, in the port's layout
    (``convert.lm_axes_to_reference`` stacks it into the reference's)."""
    return L.spec_axes(model_spec(cfg))


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


def abstract_params(cfg: ModelConfig):
    """The parameters as ``meta`` tensors (``layers.abstract_params``):
    the reference's ``abstract_params``, in the port's layout (``blocks``
    a list of the layers in order; ``convert.lm_params_to_reference``
    stacks it into the reference's)."""
    return L.abstract_params(model_spec(cfg))


# ---------------------------------------------------------------------------
# forward and fused prefill
# ---------------------------------------------------------------------------


def _kv_to_cache(k, v, length: int, dtype):
    """Place prompt K/V rows into a (B, L, KV, hd) decode cache at the
    ring slots ``pos % L`` (the identity when the prompt fits). On
    DTensors, a per-rank body on each rank's batch and heads."""
    if act.is_dtensor(k):
        kl, pl = act.local_block(k, keep=(0, 2))
        vl = v.redistribute(v.device_mesh, pl).to_local()
        ckl, cvl = _kv_to_cache(kl, vl, length, dtype)
        shape = (k.shape[0], length) + tuple(k.shape[2:])
        return (act.from_block(ckl, k.device_mesh, pl, shape),
                act.from_block(cvl, k.device_mesh, pl, shape))
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
    """A layer's self-attention decode-cache slots: ``length``, cut to the
    serve ``window`` and to the layer's sliding window; a selfcross
    layer's to ``max_target_positions`` (the reference's ring of 448
    slots, which a longer prompt wraps)."""
    eff = min(length, window) if window else length
    if kind == "selfcross":
        mtp = cfg.max_target_positions
        return min(eff, mtp) if mtp else eff
    sw = _attn_cfg(cfg, kind).sliding_window
    return min(eff, sw) if sw else eff


def _ffn(lp, cfg: ModelConfig, x):
    """The layer's FFN on its normed input: (out, the MoE's load-balance
    loss or None)."""
    if cfg.moe is not None:
        out, aux = moe_mod.moe_ffn(lp["ffn"], cfg.moe, x, cfg.act)
        return out, aux["load_balance_loss"]
    return L.mlp(lp["ffn"], x, cfg.act), None


def _gate(lp, name: str, out):
    """A cross layer's ``tanh(gate) * out`` (the gate a float32 scalar);
    ``out`` itself where the layer has no such gate."""
    if name not in lp:
        return out
    return torch.tanh(lp[name]).to(out.dtype) * out


def _apply_layer(lp, kind: str, cfg: ModelConfig, x, *, positions, aux,
                 encoder_out=None, cache_len: Optional[int] = None,
                 window: Optional[int] = None):
    """One layer: (x, aux plus the layer's MoE loss). With ``cache_len``
    (fused prefill) also the layer's decode-cache entry. ``encoder_out``:
    what a cross or selfcross layer attends to (the encoder's output or
    the patch embeddings); without it the reference's cross-attention
    attends to the layer's own input, and so does the port's."""
    cd = cfg.compute_dtype
    h = _apply_norm(cfg, lp["ln1"], x)
    want_state = cache_len is not None
    entry = None
    if kind in ("cross", "selfcross"):
        if kind == "selfcross":
            mix = attn_mod.attention(lp["attn"], cfg.attention, h,
                                     positions=positions, compute_dtype=cd,
                                     impl="xla", return_kv=want_state)
            if want_state:
                mix, (k, v) = mix
                sk, sv = _kv_to_cache(
                    k, v, _cache_len(cfg, kind, cache_len, window), cd)
            x = x + mix.to(x.dtype)
            h = _apply_norm(cfg, lp["lnx"], x)
        mix = attn_mod.attention(lp["cross_attn"], cfg.attention, h,
                                 positions=positions, kv_source=encoder_out,
                                 compute_dtype=cd, impl="xla",
                                 return_kv=want_state)
        if want_state:
            mix, (ck, cv) = mix
            entry = {"ck": ck.to(cd), "cv": cv.to(cd)}
            if kind == "selfcross":
                entry = {"k": sk, "v": sv, **entry}
        mix = _gate(lp, "gate_attn", mix)
    elif kind in ATTENTION_KINDS:
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
        x = x + _gate(lp, "gate_ffn", out).to(x.dtype)
    if want_state:
        return x, aux, entry
    return x, aux


def _embed_inputs(params, cfg: ModelConfig, tokens, positions, encoder_out):
    """The token embeddings plus the learned positions (clamped to the
    table's last row), and the encoder's output where the model has an
    encoder and frames are given (a vlm's patches pass as they are)."""
    x = L.embed(params["embed"], tokens, cfg.compute_dtype)
    if "pos_embed" in params:
        table = params["pos_embed"]["pos"]
        x = x + table.to(x.dtype)[positions.long().clamp(
            max=table.shape[0] - 1)]
    if cfg.encoder is not None and encoder_out is not None:
        encoder_out = encdec.encoder_forward(params["encoder"], cfg,
                                             encoder_out)
    return x, encoder_out


def forward_hidden(params, cfg: ModelConfig, tokens, *, encoder_out=None,
                   positions=None):
    """tokens (B, S) -> final hidden states (B, S, d_model) and the aux
    loss (float32: the layers' MoE load-balance losses summed in layer
    order, zero without MoE). ``encoder_out``: the frames (audio) or the
    patch embeddings (vlm). ``params``: a ``Params`` or a tree of tensors
    in its layout."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)[None].expand(b, s)
    x, encoder_out = _embed_inputs(params, cfg, tokens, positions,
                                   encoder_out)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = shard_activations(x)
    for i, (lp, kind) in enumerate(zip(params["blocks"], cfg.layer_kinds())):
        if remat:
            x, aux = checkpoint(_remat_layer, lp, kind, cfg, x, positions,
                                aux, encoder_out, use_reentrant=False)
        else:
            x, aux = _apply_layer(lp, kind, cfg, x, positions=positions,
                                  aux=aux, encoder_out=encoder_out)
        x = _period_end(cfg, i, x)
    x = _apply_norm(cfg, params["final_norm"], x)
    return x, aux


def _period_end(cfg: ModelConfig, i: int, x):
    """``shard_activations`` after layer ``i`` where it ends a pattern
    period (the reference's scanned block; not in the remainder)."""
    period = len(cfg.layer_pattern)
    if (i + 1) % period or i + 1 > cfg.num_layers // period * period:
        return x
    return shard_activations(x)


def _remat_layer(lp, kind, cfg, x, positions, aux, encoder_out):
    return _apply_layer(lp, kind, cfg, x, positions=positions, aux=aux,
                        encoder_out=encoder_out)


def lm_loss(params, cfg: ModelConfig, tokens, labels, *, encoder_out=None,
            seq_chunk: int = 0):
    """Mean next-token cross-entropy plus the MoE aux loss (zero without
    MoE), computed in sequence chunks of ``seq_chunk`` (default
    ``cfg.xent_chunk``). A chunk's (B, chunk, vocab) float32 logits are the
    only vocab-sized temporary and are recomputed in the backward pass, so
    the whole (B, S, vocab) logits never exist. Returns ``(loss, {"nll",
    "aux"})``. ``encoder_out``: as for :func:`forward_hidden`."""
    x, aux = forward_hidden(params, cfg, tokens, encoder_out=encoder_out)
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
    logits = shard_logits(x.float() @ w.float())
    logz = torch.logsumexp(logits, dim=-1)
    if act.is_dtensor(logits):
        # vocab-sharded logits: each shard picks the labels it holds (the
        # sum over the vocab of a one-hot product, exact), summed over the
        # shards; DTensor's masked gather has no backward
        hot = torch.nn.functional.one_hot(labels, logits.shape[-1])
        gold = torch.sum(logits * hot.to(logits.dtype), dim=-1)
    else:
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.sum(logz - gold)


def _head_matrix(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["lm_head"]["w"]


def forward(params, cfg: ModelConfig, tokens, *, encoder_out=None,
            positions=None, last_only: bool = False):
    """tokens (B, S) -> f32 logits (B, S, vocab), or (B, vocab) at the
    last position with ``last_only``, and the aux loss."""
    x, aux = forward_hidden(params, cfg, tokens, encoder_out=encoder_out,
                            positions=positions)
    if last_only:
        x = x[:, -1:]
    logits = shard_logits(x.float() @ _head_matrix(params, cfg).float())
    return (logits[:, 0] if last_only else logits), aux


def prefill(params, cfg: ModelConfig, tokens, cache_len: int, *,
            encoder_out=None, window: Optional[int] = None):
    """Fused prefill: one full-sequence pass that also emits the decode
    cache (KV rows at their ring slots, the recurrent layers' states after
    the last position), the same as feeding the prompt token by token
    through ``decode_step``. tokens: (B, P). Returns the last position's
    f32 logits (B, vocab) and the cache (as ``init_cache`` makes it).
    A serve ``window`` narrows the global attention layers' window; a
    ``local`` layer keeps its own, as in the reference. ``encoder_out``:
    as for :func:`forward_hidden`; the cross layers' ``ck``/``cv`` come
    from it. A selfcross layer's self-attention sees every prompt key even
    past ``max_target_positions``, while its cache keeps the last ones in
    a ring of that many slots: the reference's behaviour, kept."""
    if window is not None and cfg.attention is not None:
        # a ring cache of `window` slots is windowed attention: the fused
        # pass must not see keys the sequential path has evicted
        sw = cfg.attention.sliding_window
        cfg = cfg.replace(attention=dataclasses.replace(
            cfg.attention, sliding_window=min(sw, window) if sw else window))
    b, p = tokens.shape
    positions = torch.arange(p, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, p)
    x, encoder_out = _embed_inputs(params, cfg, tokens, positions,
                                   encoder_out)
    cache: List[Dict[str, torch.Tensor]] = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = shard_activations(x)
    for i, (lp, kind) in enumerate(zip(params["blocks"], cfg.layer_kinds())):
        x, aux, entry = _apply_layer(lp, kind, cfg, x, positions=positions,
                                     aux=aux, encoder_out=encoder_out,
                                     cache_len=cache_len, window=window)
        cache.append(entry)
        x = _period_end(cfg, i, x)
    x = _apply_norm(cfg, params["final_norm"], x[:, -1:])
    logits = x.float() @ _head_matrix(params, cfg).float()
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------


def _layer_cache_spec(cfg: ModelConfig, kind: str, batch: int, length: int,
                      window: Optional[int]):
    """One layer's decode-cache entry as ``meta`` tensors (the
    reference's ``_layer_cache_spec``)."""
    cd = cfg.compute_dtype
    if kind in ("cross", "selfcross"):
        a = cfg.attention
        src = (cfg.cross_attn if kind == "cross" else cfg.encoder).source_len
        entry = {name: L.meta((batch, src, a.num_kv_heads, a.head_dim), cd)
                 for name in ("ck", "cv")}
        if kind == "cross":
            return entry
        return {**attn_mod.kv_cache_spec(
            batch, _cache_len(cfg, kind, length, window), a, cd), **entry}
    if kind in ATTENTION_KINDS:
        return attn_mod.kv_cache_spec(batch,
                                      _cache_len(cfg, kind, length, window),
                                      _attn_cfg(cfg, kind), cd)
    if kind == "ssm":
        return ssm_mod.ssm_state_spec(batch, cfg.d_model, cfg.ssm, cd)
    return rglru_mod.rglru_state_spec(batch, cfg.d_model, cfg.rglru, cd)


def cache_spec(cfg: ModelConfig, batch: int, length: int,
               window: Optional[int] = None) -> List[Dict[str, torch.Tensor]]:
    """The decode cache as ``meta`` tensors, in the port's layout: a list
    of per-layer dicts (``{"k", "v"}`` of (B, slots, KV, hd) in the
    compute dtype for attention, ``{"ssm", "conv"}`` for an ssm layer and
    ``{"h", "conv"}`` for an rglru layer (float32 states, the conv windows
    in the compute dtype), ``{"ck", "cv"}`` of (B, source_len, KV, hd) for
    a cross layer, all four for a selfcross layer). The reference's
    ``cache_spec`` stacks the same entries by pattern position
    (``convert.lm_params_to_reference(cfg, {"blocks": cache})``)."""
    return [_layer_cache_spec(cfg, kind, batch, length, window)
            for kind in cfg.layer_kinds()]


def init_cache(cfg: ModelConfig, batch: int, length: int,
               window: Optional[int] = None, device=None):
    """The zero decode cache (:func:`cache_spec`) on ``device`` (the CUDA
    card unless told otherwise)."""
    return L.zeros_of(cache_spec(cfg, batch, length, window),
                      resolve_device(device))


def _cross_attend(lp, a, cfg: ModelConfig, h, ck, cv):
    """One token's cross-attention over the cached source K/V."""
    q = torch.einsum("bsd,dhk->bshk", h, L.wcast(lp["wq"], h))
    if a.qk_norm:
        q = L.rmsnorm(lp["q_norm"], q)
    q_pos = torch.zeros((1,), dtype=torch.int32, device=h.device)
    out = attn_mod.cross_sdpa(q, ck, cv, a, q_pos, cfg.compute_dtype)
    return torch.einsum("bshk,hkd->bsd", out, L.wcast(lp["wo"], out))


def _apply_layer_decode(lp, lc, kind: str, cfg: ModelConfig, x, index: int):
    cd = cfg.compute_dtype
    h = _apply_norm(cfg, lp["ln1"], x)
    if kind in ("cross", "selfcross"):
        if kind == "selfcross":
            # decode_attention writes the self K/V slots of lc in place
            mix, _ = attn_mod.decode_attention(
                lp["attn"], cfg.attention, h, lc, index, compute_dtype=cd,
                window=lc["k"].shape[1])
            x = x + mix.to(x.dtype)
            h = _apply_norm(cfg, lp["lnx"], x)
        mix = _gate(lp, "gate_attn", _cross_attend(
            lp["cross_attn"], cfg.attention, cfg, h, lc["ck"], lc["cv"]))
    elif kind in ATTENTION_KINDS:
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
            act.write_into(lc[name], t)
    x = x + mix.to(x.dtype)
    if "ffn" in lp:
        out, _ = _ffn(lp, cfg, _apply_norm(cfg, lp["ln2"], x))
        x = x + _gate(lp, "gate_ffn", out).to(x.dtype)
    return x, lc


def decode_step(params, cfg: ModelConfig, token, cache, index: int):
    """One decode step: token (B,), ``cache`` from ``init_cache`` or
    ``prefill`` (updated in place), ``index`` the token's absolute
    position (the learned positions clamp it to their last row). Returns
    (f32 logits (B, vocab), cache)."""
    pos = torch.full((token.shape[0], 1), index, device=token.device)
    x, _ = _embed_inputs(params, cfg, token[:, None], pos, None)
    for i, (lp, kind) in enumerate(zip(params["blocks"], cfg.layer_kinds())):
        x, cache[i] = _apply_layer_decode(lp, cache[i], kind, cfg, x, index)
    x = _apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = L.unembed(params["embed"], x)
    else:
        logits = x.float() @ params["lm_head"]["w"].float()
    return logits[:, 0], cache
