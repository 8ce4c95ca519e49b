"""Grouped-query attention with RoPE, qk-norm, sliding windows and a KV cache.

Counterpart of ``repro/models/attention.py`` for self-attention. The
full-sequence path (prefill) runs the flash kernel (``impl="flash"``,
kernel #8 through ``kernels/ops.py``; forward only), the plain grouped
attention over query chunks (``impl="chunked"``, the reference's default
and the training path: differentiable, each chunk recomputed in the
backward pass) or in one block (``impl="xla"``); the decode path attends
one new token over a (possibly ring-buffered) KV cache, which it updates
in place (the reference returns a new cache; the port's cache is the
serve loop's own, so nothing is lost). ``impl="banded"`` is the
reference's static band: unrolled query blocks, each sliced to the keys
its window can reach. With ``kv_source`` (B, S_src, d_model) the keys and
values come from an encoder's output or patch embeddings instead of x:
cross-attention, non-causal, unwindowed, no rope on either side, always on
the plain grouped attention (the reference routes it there whatever
``impl`` says).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import AttentionConfig
from repro_torch.models.layers import (P, meta, rmsnorm, rmsnorm_spec, wcast,
                                       zeros_of)
from repro_torch.sharding import act
from repro_torch.sharding.act import write_into

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) integer. Half-split
    convention, angles in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., :, None].float() * freqs            # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., :, None, :]
    xf1, xf2 = x[..., : hd // 2].float(), x[..., hd // 2:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# spec
# ---------------------------------------------------------------------------


def attention_spec(d_model: int, a: AttentionConfig,
                   dtype=torch.float32) -> Dict:
    s = {
        "wq": P((d_model, a.num_heads, a.head_dim),
                ("embed", "heads", "head_dim"), init="fan_in", dtype=dtype),
        "wk": P((d_model, a.num_kv_heads, a.head_dim),
                ("embed", "kv_heads", "head_dim"), init="fan_in",
                dtype=dtype),
        "wv": P((d_model, a.num_kv_heads, a.head_dim),
                ("embed", "kv_heads", "head_dim"), init="fan_in",
                dtype=dtype),
        "wo": P((a.num_heads, a.head_dim, d_model),
                ("heads", "head_dim", "embed"), init="fan_in", dtype=dtype),
    }
    if a.qk_norm:
        s["q_norm"] = rmsnorm_spec(a.head_dim, dtype)
        s["k_norm"] = rmsnorm_spec(a.head_dim, dtype)
    return s


def project_kv(params, a: AttentionConfig, src):
    """The keys and values of ``src`` (B, S, d_model), k-normed where the
    config says: (B, S, KV, hd) each, in ``src``'s dtype."""
    k = torch.einsum("bsd,dhk->bshk", src, wcast(params["wk"], src))
    v = torch.einsum("bsd,dhk->bshk", src, wcast(params["wv"], src))
    if a.qk_norm:
        k = rmsnorm(params["k_norm"], k)
    return k, v


def _project_qkv(params, a: AttentionConfig, x, kv_source=None):
    q = torch.einsum("bsd,dhk->bshk", x, wcast(params["wq"], x))
    if a.qk_norm:
        q = rmsnorm(params["q_norm"], q)
    k, v = project_kv(params, a, x if kv_source is None else kv_source)
    return q, k, v


def make_mask(a: AttentionConfig, q_pos, k_pos):
    """Boolean attention mask from query/key position vectors: q_pos (Sq,),
    k_pos (Sk,) -> (1, 1, Sq, Sk). Causal and/or windowed."""
    diff = q_pos[:, None] - k_pos[None, :]
    mask = torch.ones_like(diff, dtype=torch.bool)
    if a.causal:
        mask &= diff >= 0
    if a.sliding_window is not None:
        mask &= diff < a.sliding_window
    return mask[None, None]


def _inv_sqrt(hd: int) -> float:
    """1/sqrt(hd) as the reference computes it, in f32."""
    return float(1.0 / torch.sqrt(torch.tensor(float(hd))))


def _grouped_sdpa(q, k, v, a: AttentionConfig, q_pos, k_pos, compute_dtype):
    """Grouped-query attention without repeating K/V: q (B, Sq, H, hd),
    k/v (B, Sk, KV, hd), q_pos (Sq,), k_pos (Sk,). Logits and softmax in
    f32; the probabilities are cast to the compute dtype before P V. On
    DTensors, :func:`_sdpa_on_ranks`."""
    if act.is_dtensor(q):
        return _sdpa_on_ranks(q, k, v, a, q_pos, k_pos, compute_dtype)
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd)
    logits = torch.einsum("bqgrk,bsgk->bgrqs", qg.float(),
                          k.float()) * _inv_sqrt(hd)
    logits = torch.where(make_mask(a, q_pos, k_pos)[0, 0], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqs,bsgk->bqgrk", probs.to(compute_dtype),
                       v.to(compute_dtype))
    return out.reshape(b, sq, h, hd)


def _chunked_sdpa(q, k, v, a: AttentionConfig, positions, compute_dtype,
                  chunk: int):
    """Memory-efficient attention: the grouped attention over query chunks
    of ``chunk`` rows, each chunk recomputed in the backward pass (the
    reference's ``jax.checkpoint`` of its scan body), so a chunk's
    (B, KV, rep, chunk, Sk) logits are the only attention-sized
    temporary. ``positions``: (S,).

    Sliding-window layers read only the key span that can be in-window for
    the chunk: ``window + chunk`` keys rounded up to a multiple of the
    chunk, starting where the reference's ``dynamic_slice`` starts."""
    b, s, h, hd = q.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the attention "
                         f"chunk {chunk}")
    kspan = s
    if a.sliding_window is not None and a.causal:
        win = a.sliding_window
        kspan = min(s, -(-(win + chunk) // chunk) * chunk)

    def body(q_i, k_i, v_i, pos_i, kp_i):
        return _grouped_sdpa(q_i, k_i, v_i, a, pos_i, kp_i, compute_dtype)

    out = []
    for i in range(s // chunk):
        q0 = i * chunk
        start = min(max(q0 + chunk - kspan, 0), s - kspan)
        out.append(checkpoint(
            body, q[:, q0:q0 + chunk], k[:, start:start + kspan],
            v[:, start:start + kspan], positions[q0:q0 + chunk],
            positions[start:start + kspan], use_reentrant=False))
    return torch.cat(out, dim=1)


def _banded_sdpa(q, k, v, a: AttentionConfig, positions, compute_dtype,
                 chunk: int):
    """Sliding-window attention as a static band: unrolled query blocks of
    ``max(chunk, min(window, 4096))`` rows (the last one ragged), each
    attending over the ``window + chunk`` keys, rounded up to the block,
    that end with it (the reference's span arithmetic). Without a causal
    window it is the plain grouped attention. ``positions``: (S,)."""
    s = q.shape[1]
    win = a.sliding_window
    if win is None or not a.causal:
        return _grouped_sdpa(q, k, v, a, positions, positions, compute_dtype)
    chunk = min(max(chunk, min(win, 4096)), s)
    kspan = min(s, -(-(win + chunk) // chunk) * chunk)
    out = []
    for q0 in range(0, s, chunk):
        q1 = min(q0 + chunk, s)
        start = max(0, min(q1 - kspan, s - kspan))
        out.append(_grouped_sdpa(
            q[:, q0:q1], k[:, start:start + kspan], v[:, start:start + kspan],
            a, positions[q0:q1], positions[start:start + kspan],
            compute_dtype))
    return torch.cat(out, dim=1)


def _local_qkv(q, k, v, keep_length: bool = False):
    """Each rank's shards of DTensors q, k, v for a per-rank attention
    body (the reference's ``shard_map`` around an attention call): q in
    ``act.shard_heads``' layout (batch over the batch axes, heads over
    model, under an activation context), and the kv heads its query heads
    read under GQA (q head h reads kv head h // (H / KV)): its own shard
    of k/v where the kv heads split as the query heads do, else the slice
    it needs of the replicated k/v (8 kv heads on a 16-way model axis).
    With ``keep_length`` a shard of k/v's length dim stays where q is
    replicated (the context-parallel decode cache). Returns (q, k, v
    local, q's placements, k's)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    ql, qp = act.local_block(act.shard_heads(q), keep=(0, 2))
    h, kv = q.shape[2], k.shape[2]
    rep = h // kv
    (_, _, hl, _), (_, _, h0, _) = act.local_offset(q.shape, mesh, qp)
    aligned = hl % rep == 0
    held = act.is_dtensor(k)
    kp = []
    for m, p in enumerate(qp):
        if p.is_shard(2) and aligned:
            kp.append(Shard(2))
        elif p.is_shard(0):
            kp.append(Shard(0))
        elif keep_length and held and not p.is_shard(2) \
                and k.placements[m].is_shard(1):
            kp.append(Shard(1))
        else:
            kp.append(Replicate())
    # under autograd a replicated k/v feeds each rank's own query heads:
    # its gradient is the ranks' sum (act.body_input)
    kl, vl = (act.body_input(t, kp, qp) if held else t for t in (k, v))
    if not aligned:
        if rep % hl:
            raise ValueError(f"{hl} local query heads of {h} straddle the "
                             f"kv heads ({rep} query heads a kv head)")
        kl = kl[:, :, h0 // rep:h0 // rep + 1]
        vl = vl[:, :, h0 // rep:h0 // rep + 1]
    return ql, kl, vl, qp, kp


def _sdpa_on_ranks(q, k, v, a: AttentionConfig, q_pos, k_pos,
                   compute_dtype):
    """The grouped attention on each rank's shards (:func:`_local_qkv`).
    Where the keys' length is sharded (the context-parallel decode cache)
    each rank takes its slots' logits, the logits of a row are gathered
    over the length shards for the softmax (B x KV x rep x Sq x S floats:
    a decode step's is small), and each rank's P V over its slots is
    summed over them (``sharding.compat``). The output keeps q's
    placements."""
    from repro_torch.sharding import compat
    mesh = q.device_mesh
    ql, kl, vl, qp, kp = _local_qkv(q, k, v, keep_length=True)
    names = mesh.mesh_dim_names
    length = tuple(names[m] for m, p in enumerate(kp) if p.is_shard(1))
    (_, s_l, _, _), (_, off, _, _) = act.local_offset(k.shape, mesh, kp)
    b, sq, hl, hd = ql.shape
    kvl = kl.shape[2]
    qg = ql.reshape(b, sq, kvl, hl // kvl, hd)
    logits = torch.einsum("bqgrk,bsgk->bgrqs", qg.float(),
                          kl.float()) * _inv_sqrt(hd)
    mask = make_mask(a, q_pos, k_pos[off:off + s_l])[0, 0]
    logits = torch.where(mask, logits, NEG_INF)
    if length:
        axis = compat.mesh_axis(mesh, length)
        rows = logits.movedim(-1, 0).contiguous()
        full = compat.gather_rows([rows], [s_l] * axis.size, axis)[0]
        probs = torch.softmax(full.movedim(0, -1), dim=-1)
        probs = probs[..., off:off + s_l]
    else:
        probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqs,bsgk->bqgrk", probs.to(compute_dtype),
                       vl.to(compute_dtype))
    if length:
        out = compat.psum(out.float(), axis).to(out.dtype)
    return act.from_block(out.reshape(b, sq, hl, hd), mesh, qp, q.shape)


def _flash(q, k, v, a: AttentionConfig):
    """Kernel #8 (``kernels/ops.py::flash_attention``); on DTensors a
    per-rank body on each rank's batch rows and heads
    (:func:`_local_qkv`), its output at q's placements."""
    from repro_torch.kernels import ops as kops
    if not act.is_dtensor(q):
        return kops.flash_attention(q, k, v, causal=a.causal,
                                    window=a.sliding_window)
    ql, kl, vl, qp, _ = _local_qkv(q, k, v)
    out = kops.flash_attention(ql, kl, vl, causal=a.causal,
                               window=a.sliding_window)
    return act.from_block(out, q.device_mesh, qp, q.shape)


def cross_sdpa(q, k, v, a: AttentionConfig, q_pos, compute_dtype):
    """Cross-attention over a whole source: the grouped attention with no
    causal mask and no window, the source at positions 0 .. S_src - 1."""
    a_x = dataclasses.replace(a, causal=False, sliding_window=None)
    src_pos = torch.arange(k.shape[1], dtype=torch.int32, device=k.device)
    return _grouped_sdpa(q, k, v, a_x, q_pos, src_pos, compute_dtype)


# ---------------------------------------------------------------------------
# full-sequence attention (prefill)
# ---------------------------------------------------------------------------


def attention(params, a: AttentionConfig, x, *, positions=None,
              kv_source=None, compute_dtype=torch.bfloat16,
              impl: str = "flash", attn_chunk: int = 512,
              return_kv: bool = False):
    """Full-sequence attention: x (B, S, d_model) -> (B, S, d_model), or
    ``(out, (k, v))`` with the (rope'd) keys and values when ``return_kv``
    (the fused prefill's decode cache). ``kv_source`` (B, S_src, d_model):
    cross-attention to it (see the module note); its k and v are returned.
    ``attn_chunk``: the query chunk of ``impl="chunked"`` and
    ``"banded"``."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, a, x, kv_source)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    if a.use_rope and kv_source is None:
        q = apply_rope(q, positions, a.rope_theta)
        k = apply_rope(k, positions, a.rope_theta)
    if kv_source is not None:
        out = cross_sdpa(q, k, v, a, positions[0], compute_dtype)
    elif impl == "flash":
        out = _flash(q, k, v, a)
    elif impl == "xla":
        out = _grouped_sdpa(q, k, v, a, positions[0], positions[0],
                            compute_dtype)
    elif impl == "chunked":
        out = _chunked_sdpa(q, k, v, a, positions[0], compute_dtype,
                            attn_chunk)
    elif impl == "banded":
        out = _banded_sdpa(q, k, v, a, positions[0], compute_dtype,
                           attn_chunk)
    else:
        raise ValueError(f"unknown attn_impl {impl!r}")
    out = torch.einsum("bshk,hkd->bsd", out, wcast(params["wo"], out))
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# KV cache + decode step
# ---------------------------------------------------------------------------


def kv_cache_spec(batch: int, length: int, a: AttentionConfig, dtype):
    """One layer's KV cache as ``meta`` tensors: {"k", "v"} of
    (B, L, KV, hd)."""
    shape = (batch, length, a.num_kv_heads, a.head_dim)
    return {"k": meta(shape, dtype), "v": meta(shape, dtype)}


def init_kv_cache(batch: int, length: int, a: AttentionConfig, dtype,
                  device=None):
    """One layer's KV cache: {"k", "v"} of (B, L, KV, hd) zeros."""
    return zeros_of(kv_cache_spec(batch, length, a, dtype), device)


def decode_attention(params, a: AttentionConfig, x, cache, index: int, *,
                     compute_dtype=torch.bfloat16,
                     window: Optional[int] = None, kv_source=None):
    """One-token decode: x (B, 1, D); ``cache`` holds L past positions and
    is updated in place; ``index`` is the new token's absolute position.
    With ``window`` the cache is a ring buffer of L slots and writes wrap.
    With ``kv_source`` (B, S_src, d_model) the token cross-attends to the
    whole source, projected anew, and the cache is left alone. Returns
    (out, cache)."""
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(params, a, x)
    if a.use_rope:
        pos = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos, a.rope_theta)
        k_new = apply_rope(k_new, pos, a.rope_theta)
    if kv_source is not None:
        k, v = project_kv(params, a, kv_source)
        q_pos = torch.zeros((1,), dtype=torch.int32, device=x.device)
        out = cross_sdpa(q, k, v, a, q_pos, compute_dtype)
        return (torch.einsum("bshk,hkd->bsd", out, wcast(params["wo"], out)),
                cache)

    n_slots = cache["k"].shape[1]
    # the reference's dynamic_update_slice clamps a start past the end
    slot = index % n_slots if window is not None else min(index, n_slots - 1)
    # into the shard that holds the slot when the cache is a DTensor
    write_into(cache["k"], k_new[:, 0].to(cache["k"].dtype), slot)
    write_into(cache["v"], v_new[:, 0].to(cache["v"].dtype), slot)

    # absolute key position of each slot (ring-buffer aware)
    slots = torch.arange(n_slots, dtype=torch.int64, device=x.device)
    k_pos = index - ((slot - slots) % n_slots) if window is not None else slots
    valid = (k_pos >= 0) & (k_pos <= index)
    # an invalid slot gets a future position: the causal mask drops it
    k_pos = torch.where(valid, k_pos, index + 1)
    a_d = a if a.sliding_window is None else dataclasses.replace(
        a, sliding_window=min(a.sliding_window, n_slots))
    q_pos = torch.full((1,), index, dtype=torch.int64, device=x.device)
    out = _grouped_sdpa(q, cache["k"], cache["v"], a_d, q_pos, k_pos,
                        compute_dtype)
    return torch.einsum("bshk,hkd->bsd", out, wcast(params["wo"], out)), cache
