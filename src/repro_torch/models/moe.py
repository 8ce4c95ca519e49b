"""Mixture-of-Experts FFN: a top-k router and a capacity-bound grouped
dispatch into an (E, C, D) expert buffer.

Counterpart of ``repro/models/moe.py``. Tokens are split into
``m.dispatch_groups`` groups (1 unless the group count divides the
tokens), each with its own buffer of C = ``_capacity`` slots an expert.
The orders are the reference's, so the same tokens go to the same
experts and the same ones overflow:

- the router's logits and softmax in float32;
- top-k with the lower expert index first on ties, as ``jax.lax.top_k``
  breaks them (a stable descending sort, not ``torch.topk``), the gates
  renormalised to sum 1 when K > 1;
- a token's slot in its expert by a cumsum over the group's (Tg·K)
  assignments in token-major order; a slot at or past C drops the
  assignment (GShard), counted in ``drop_fraction``;
- the combine gathers each kept slot's output, weights it by its gate in
  the activation dtype and adds a token's K outputs in order k = 0, 1, ...

The expert products are batched matmuls over the experts, as the
reference's einsums are. On one device the reference never takes its
``combine="reduce"`` branch (``_reduce_combine_ctx`` needs a mesh), so
the port has the gather combine only; the reduce combine waits for the
mesh (ROADMAP queue 1 item 11).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config.base import MoEConfig
from repro_torch.models.layers import P
from repro_torch.utils.metrics import mean_of_mask


def moe_spec(d_model: int, m: MoEConfig, act: str,
             dtype=torch.float32) -> Dict:
    e, f = m.num_experts, m.d_ff_expert
    s = {
        "router": P((d_model, e), init="fan_in", dtype=torch.float32),
        "w_up": P((e, d_model, f), init="fan_in", dtype=dtype),
        "w_down": P((e, f, d_model), init="fan_in", dtype=dtype),
    }
    if act == "swiglu":
        s["w_gate"] = P((e, d_model, f), init="fan_in", dtype=dtype)
    return s


def _capacity(tokens: int, m: MoEConfig) -> int:
    c = int(tokens * m.capacity_factor * m.top_k / m.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def route(params, m: MoEConfig, x, experts=None):
    """The router of ``moe_ffn``: x (B, S, D) -> the float32 probabilities
    (G, Tg, E), the gates (G, Tg, K), the experts (G, Tg, K) int64, each
    assignment's slot (G, Tg·K), the keep mask (G, Tg·K) and C.

    ``experts`` (G, Tg, K), when given, stands for the top-k choice, and
    the gates are the probabilities at those experts (renormalised as
    ever): one path's choices pinned on another, so that two attention
    paths can be compared where a near-tie in bf16 flips a choice."""
    b, s, d = x.shape
    t = b * s
    e, k = m.num_experts, m.top_k
    g = (m.dispatch_groups
         if m.dispatch_groups > 0 and t % m.dispatch_groups == 0 else 1)
    tg = t // g
    c = _capacity(tg, m)
    logits = x.reshape(g, tg, d).float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    if experts is None:
        gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                           stable=True)
        gate_vals, expert_idx = gate_vals[..., :k], expert_idx[..., :k]
    else:
        expert_idx = experts.to(torch.int64)
        gate_vals = torch.gather(probs, -1, expert_idx)
    if k > 1:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    flat = expert_idx.reshape(g, tg * k)
    onehot = F.one_hot(flat, e).to(torch.int32)              # (G, Tg·K, E)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    slot = torch.gather(pos, 2, flat[..., None])[..., 0]
    keep = slot < c
    return probs, gate_vals, expert_idx, slot, keep, c


def moe_ffn(params, m: MoEConfig, x, act: str) -> Tuple[torch.Tensor, Dict]:
    """x (B, S, D) -> (B, S, D) and the aux stats ``load_balance_loss``
    (switch-style, times ``router_aux_weight``) and ``drop_fraction``,
    float32 scalars."""
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    probs, gate_vals, expert_idx, slot, keep, c = route(params, m, x)
    g, tg = probs.shape[:2]
    xt = x.reshape(g, tg, d)
    flat = expert_idx.reshape(g, tg * k)
    safe = torch.where(keep, slot, c - 1).long()
    token = torch.arange(tg, device=x.device).repeat_interleave(k)

    out = []
    for gi in range(g):
        # dispatch: each kept assignment into its (expert, slot); a dropped
        # one adds zero at the expert's last slot, as the reference's does
        contrib = torch.where(keep[gi, :, None], xt[gi][token],
                              0).to(x.dtype)
        buf = torch.zeros((e, c, d), dtype=x.dtype, device=x.device)
        buf.index_put_((flat[gi], safe[gi]), contrib, accumulate=True)
        up = torch.bmm(buf, params["w_up"].to(buf.dtype))
        if act == "swiglu":
            gate = torch.bmm(buf, params["w_gate"].to(buf.dtype))
            h = F.silu(gate.float()).to(x.dtype) * up
        else:
            h = F.gelu(up.float(), approximate="tanh").to(x.dtype)
        ob = torch.bmm(h, params["w_down"].to(h.dtype))      # (E, C, D)
        # combine: gather, weight by the gate, add a token's K outputs in
        # order (the reference's scatter-add over repeated token indices)
        gathered = torch.where(keep[gi, :, None], ob[flat[gi], safe[gi]], 0)
        weighted = (gathered * gate_vals[gi].reshape(-1, 1).to(x.dtype)
                    ).reshape(tg, k, d)
        acc = torch.zeros((tg, d), dtype=x.dtype, device=x.device)
        for j in range(k):
            acc = acc + weighted[:, j]
        out.append(acc)

    # the means as XLA takes them: the sum times the float32 1 / n
    probs_t = probs.reshape(-1, e)
    inv_t = float(np.float32(1) / np.float32(probs_t.shape[0]))
    me = probs_t.sum(0) * inv_t
    ce = F.one_hot(expert_idx[..., 0].reshape(-1), e).sum(0).float() * inv_t
    aux = {"load_balance_loss": e * torch.sum(me * ce) * m.router_aux_weight,
           "drop_fraction": 1.0 - mean_of_mask(keep)}
    return torch.stack(out).reshape(b, s, d), aux
