"""RG-LRU recurrent block (Griffin / RecurrentGemma [arXiv:2402.19427]).

h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t),
a_t = exp(-c · softplus(Λ) · r_t),  r_t, i_t = σ(block-diagonal linear of x_t).

Counterpart of ``repro/models/rglru.py``. The reference runs the
recurrence of the full sequence as ``jax.lax.associative_scan`` over time;
here it is a Hillis–Steele scan, log2(S) steps of whole-tensor products
in float32 (not a loop of S steps, which at S = 3072 would be thousands of
launches a layer). Its products associate in another order than the
reference's scan, so the two agree within rounding, not bit for bit.
Decode is the one-step recurrence. The recurrence runs in float32, the
matmuls in the compute dtype; ``jax.nn.gelu`` is the tanh approximation.

On DTensors (a step on a mesh) the block runs as a per-rank body on this
rank's heads (``sharding/act.py``): the two input projections' products
are taken with their width sharded over ``model`` (a head's channels are
a contiguous block of the width), and the conv, the block-diagonal gates
and the scan run on the local channels, with ``conv_w``, ``conv_b``,
``lam``, ``w_a``/``w_i`` and ``b_a``/``b_i`` resharded to the same heads
whether the rules shard them or keep them whole; the output projection
takes the channels' rows, and the decode state is the channels' ``h``
and conv window.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import RGLRUConfig
from repro_torch.models.layers import (P, causal_conv, meta, softplus,
                                       zeros_of)


def rglru_dims(d_model: int, r: RGLRUConfig):
    width = r.lru_width or d_model
    heads = r.num_heads or 8
    if width % heads:
        raise ValueError(f"lru width {width} does not split into {heads} "
                         "heads")
    return width, heads


def rglru_spec(d_model: int, r: RGLRUConfig, dtype=torch.float32) -> Dict:
    width, heads = rglru_dims(d_model, r)
    hw = width // heads
    return {
        "w_x": P((d_model, width), ("embed", "ffn"), init="fan_in",
                 dtype=dtype),
        "w_y": P((d_model, width), ("embed", "ffn"), init="fan_in",
                 dtype=dtype),
        "conv_w": P((r.d_conv, width), ("conv", "ffn"), init="fan_in",
                    dtype=dtype),
        "conv_b": P((width,), ("ffn",), init="zeros", dtype=dtype),
        # block-diagonal gates (recurrence gate a, input gate i)
        "w_a": P((heads, hw, hw), ("heads", None, None), init="fan_in",
                 dtype=dtype),
        "b_a": P((heads, hw), ("heads", None), init="zeros", dtype=dtype),
        "w_i": P((heads, hw, hw), ("heads", None, None), init="fan_in",
                 dtype=dtype),
        "b_i": P((heads, hw), ("heads", None), init="zeros", dtype=dtype),
        "lam": P((width,), ("ffn",), init="normal", scale=0.5,
                 dtype=torch.float32),
        "w_out": P((width, d_model), ("ffn", "embed"), init="fan_in",
                   dtype=dtype),
    }


def _gates(params, r: RGLRUConfig, x, width: int, heads: int):
    """x (B, S, width) -> log a (float32) and the gated input (float32),
    both (B, S, width)."""
    xh = x.reshape(*x.shape[:-1], heads, width // heads)
    ra = (torch.einsum("...hk,hkj->...hj", xh, params["w_a"].to(xh.dtype))
          + params["b_a"].to(x.dtype))
    ri = (torch.einsum("...hk,hkj->...hj", xh, params["w_i"].to(xh.dtype))
          + params["b_i"].to(x.dtype))
    rt = torch.sigmoid(ra.float()).reshape(*x.shape[:-1], width)
    it = torch.sigmoid(ri.float()).reshape(*x.shape[:-1], width)
    log_a = -r.c * softplus(params["lam"]) * rt
    a2 = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a2, 1e-12)) * it * x.float()
    return log_a, gated


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t over dim 1 from h_{-1} = 0: a Hillis–Steele
    scan of the reference's combine ``(a1, b1), (a2, b2) -> (a1 a2,
    a2 b1 + b2)`` in ceil(log2 S) steps."""
    s = a.shape[1]
    step = 1
    while step < s:
        b = torch.cat([b[:, :step], a[:, step:] * b[:, :-step] + b[:, step:]],
                      dim=1)
        if 2 * step < s:
            a = torch.cat([a[:, :step], a[:, step:] * a[:, :-step]], dim=1)
        step *= 2
    return b


def _on_ranks(params, r: RGLRUConfig, d_model: int, x, state,
              compute_dtype, return_state: bool):
    """:func:`rglru_forward` (``state`` None) or :func:`rglru_step` on
    DTensors: a per-rank body on this rank's heads (the module note)."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding import act
    mesh = x.device_mesh
    width, heads = rglru_dims(d_model, r)
    bsz, seq, _ = x.shape
    w, _ = act.model_share(x, heads)
    hl = heads // w
    pl_out = act.body_placements(x, 2, w > 1)
    pl_h = act.body_placements(x, 1, w > 1)

    def chans(t, dim):      # a parameter at this rank's heads along dim
        pl = [Shard(dim) if w > 1 and o.is_shard() and o.dim == 2
              else Replicate() for o in pl_out]
        return act.body_input(t, pl, pl_out)

    y_branch = F.gelu(act.body_input(x @ params["w_y"].to(x.dtype), pl_out,
                                     pl_out).float(), approximate="tanh")
    xw = act.body_input(x @ params["w_x"].to(x.dtype), pl_out, pl_out)
    conv = {"conv_w": chans(params["conv_w"], 1),
            "conv_b": chans(params["conv_b"], 0)}
    prev = (None if state is None else
            act.body_input(state["conv"], pl_out, pl_out))
    xb, window = causal_conv(conv, xw, prev)
    local = {"w_a": chans(params["w_a"], 0), "b_a": chans(params["b_a"], 0),
             "w_i": chans(params["w_i"], 0), "b_i": chans(params["b_i"], 0),
             "lam": chans(params["lam"], 0)}
    log_a, gated = _gates(local, r, xb, width // w, hl)
    if state is None:
        h = linear_scan(torch.exp(log_a), gated)
    else:
        h = (torch.exp(log_a[:, 0]) * act.body_input(state["h"], pl_h, pl_out)
             + gated[:, 0])[:, None]
    out = act.from_block((h * y_branch).to(compute_dtype), mesh, pl_out,
                         (bsz, seq, width))
    out = out @ params["w_out"].to(out.dtype)
    if state is None and not return_state:
        return out
    return out, {"h": act.from_block(h[:, -1].clone(), mesh, pl_h,
                                     (bsz, width)),
                 "conv": act.from_block(window.to(compute_dtype), mesh,
                                        pl_out, (bsz, r.d_conv - 1, width))}


def rglru_forward(params, r: RGLRUConfig, d_model: int, x, *,
                  compute_dtype=torch.bfloat16, return_state: bool = False):
    """The full-sequence block: x (B, S, d_model) -> the same shape; with
    ``return_state`` also the decode state {"h", "conv"} after the last
    position (the fused prefill). On DTensors a per-rank body on this
    rank's heads (the module note)."""
    from repro_torch.sharding.act import is_dtensor
    if is_dtensor(x):
        return _on_ranks(params, r, d_model, x, None, compute_dtype,
                         return_state)
    width, heads = rglru_dims(d_model, r)
    y_branch = F.gelu((x @ params["w_y"].to(x.dtype)).float(),
                      approximate="tanh")
    xb, conv_state = causal_conv(params, x @ params["w_x"].to(x.dtype))
    log_a, gated = _gates(params, r, xb, width, heads)
    h = linear_scan(torch.exp(log_a), gated)
    out = (h * y_branch).to(compute_dtype)
    out = out @ params["w_out"].to(out.dtype)
    if return_state:
        return out, {"h": h[:, -1].clone(),
                     "conv": conv_state.to(compute_dtype)}
    return out


def rglru_state_spec(batch: int, d_model: int, r: RGLRUConfig,
                     dtype) -> Dict[str, torch.Tensor]:
    """The decode state as ``meta`` tensors: ``h`` (B, width) float32 and
    ``conv`` (B, d_conv - 1, width) in ``dtype``."""
    width, _ = rglru_dims(d_model, r)
    return {"h": meta((batch, width), torch.float32),
            "conv": meta((batch, r.d_conv - 1, width), dtype)}


def init_rglru_state(batch: int, d_model: int, r: RGLRUConfig, dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    """The zero decode state (:func:`rglru_state_spec`) on ``device``."""
    return zeros_of(rglru_state_spec(batch, d_model, r, dtype), device)


def rglru_step(params, r: RGLRUConfig, d_model: int, x, state, *,
               compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict]:
    """One token: x (B, 1, d_model). Returns the output and the new state
    (new tensors). On DTensors a per-rank body on this rank's heads (the
    module note)."""
    from repro_torch.sharding.act import is_dtensor
    if is_dtensor(x):
        return _on_ranks(params, r, d_model, x, state, compute_dtype, True)
    width, heads = rglru_dims(d_model, r)
    y_branch = F.gelu((x @ params["w_y"].to(x.dtype)).float(),
                      approximate="tanh")
    xb, conv_state = causal_conv(params, x @ params["w_x"].to(x.dtype),
                                 conv_state=state["conv"])
    log_a, gated = _gates(params, r, xb, width, heads)
    h = torch.exp(log_a[:, 0]) * state["h"] + gated[:, 0]
    out = (h[:, None] * y_branch).to(compute_dtype)
    return out @ params["w_out"].to(out.dtype), {"h": h, "conv": conv_state}
