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
``combine="reduce"`` branch (``_reduce_combine_ctx`` needs a mesh), and
neither does the port. Under a mesh (DTensor inputs) ``moe_ffn`` runs a
per-rank body, :func:`_moe_on_ranks`, which takes the reduce combine
where the reference's rule does and counts each call's combine in
``COMBINE_COUNTS``.
"""
from __future__ import annotations

import dataclasses
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
        "router": P((d_model, e), ("embed", "expert_router"),
                    init="fan_in", dtype=torch.float32),
        "w_up": P((e, d_model, f), ("expert", "embed", "expert_ffn"),
                  init="fan_in", dtype=dtype),
        "w_down": P((e, f, d_model), ("expert", "expert_ffn", "embed"),
                    init="fan_in", dtype=dtype),
    }
    if act == "swiglu":
        s["w_gate"] = P((e, d_model, f), ("expert", "embed", "expert_ffn"),
                        init="fan_in", dtype=dtype)
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


def _expert_outputs(w, buf, act: str, dtype):
    """The expert FFN on a dispatch buffer (E, C, D) with the weights
    ``w`` (whole, or a rank's shard of d_ff_expert or of the experts):
    (E, C, D), a partial sum over d_ff_expert when ``w`` is its shard."""
    up = torch.bmm(buf, w["w_up"].to(buf.dtype))
    if act == "swiglu":
        gate = torch.bmm(buf, w["w_gate"].to(buf.dtype))
        h = F.silu(gate.float()).to(dtype) * up
    else:
        h = F.gelu(up.float(), approximate="tanh").to(dtype)
    return torch.bmm(h, w["w_down"].to(h.dtype))


def _dispatch(xg, flat, safe, keep, token, e: int, c: int):
    """One group's (E, C, D) buffer: each kept assignment into its
    (expert, slot); a dropped one adds zero at the expert's last slot, as
    the reference's does."""
    contrib = torch.where(keep[:, None], xg[token], 0).to(xg.dtype)
    buf = torch.zeros((e, c, xg.shape[-1]), dtype=xg.dtype, device=xg.device)
    buf.index_put_((flat, safe), contrib, accumulate=True)
    return buf


def _combine(ob, flat, safe, keep, gates, k: int, dtype):
    """Gather each kept slot's output, weight it by its gate in ``dtype``
    and add a token's K outputs in order k = 0, 1, ... (the reference's
    scatter-add over repeated token indices): (Tg, D)."""
    gathered = torch.where(keep[:, None], ob[flat, safe], 0)
    weighted = (gathered * gates.reshape(-1, 1).to(dtype)).reshape(
        -1, k, ob.shape[-1])
    acc = torch.zeros(weighted[:, 0].shape, dtype=dtype, device=ob.device)
    for j in range(k):
        acc = acc + weighted[:, j]
    return acc


def moe_ffn(params, m: MoEConfig, x, act: str) -> Tuple[torch.Tensor, Dict]:
    """x (B, S, D) -> (B, S, D) and the aux stats ``load_balance_loss``
    (switch-style, times ``router_aux_weight``) and ``drop_fraction``,
    float32 scalars. On DTensors (a step under a mesh) a per-rank body:
    :func:`_moe_on_ranks`."""
    from repro_torch.sharding.act import is_dtensor
    if is_dtensor(x):
        return _moe_on_ranks(params, m, x, act)
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
        buf = _dispatch(xt[gi], flat[gi], safe[gi], keep[gi], token, e, c)
        ob = _expert_outputs(params, buf, act, x.dtype)      # (E, C, D)
        out.append(_combine(ob, flat[gi], safe[gi], keep[gi], gate_vals[gi],
                            k, x.dtype))

    # the means as XLA takes them: the sum times the float32 1 / n
    probs_t = probs.reshape(-1, e)
    inv_t = float(np.float32(1) / np.float32(probs_t.shape[0]))
    me = probs_t.sum(0) * inv_t
    ce = F.one_hot(expert_idx[..., 0].reshape(-1), e).sum(0).float() * inv_t
    aux = {"load_balance_loss": e * torch.sum(me * ce) * m.router_aux_weight,
           "drop_fraction": 1.0 - mean_of_mask(keep)}
    return torch.stack(out).reshape(b, s, d), aux


# the combine each call of the per-rank body took, counted
COMBINE_COUNTS = {"reduce": 0, "gather": 0}


def _reduce_combine_ctx(m: MoEConfig):
    """(ctx, model_axis, batch_shards) when the combine-before-reduce path
    can run (the reference's rule): 'tensor' sharding, an active mesh
    context with non-empty batch axes, model axis size > 1."""
    from repro_torch.sharding.act import current_ctx
    if m.sharding != "tensor":
        return None
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None or not ctx.batch_axes:
        return None
    if ctx.mesh_sizes.get(ctx.model_axis, 1) <= 1:
        return None
    bsz = int(np.prod([ctx.mesh_sizes.get(a, 1) for a in ctx.batch_axes]))
    if bsz <= 0:
        return None
    return ctx, ctx.model_axis, bsz


def _weight_block(w, mesh, model_axis: str, dim: int, size: int):
    """A weight's local tensor sharded over ``model_axis`` on ``dim`` (where
    ``size`` divides it) and whole over every other mesh dim (an FSDP
    shard is gathered, as GSPMD gathers it before a use)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    want = [Replicate()] * len(names)
    split = size > 1 and w.shape[dim] % size == 0
    if split:
        want[names.index(model_axis)] = Shard(dim)
    if list(w.placements) != want:
        w = w.redistribute(mesh, want)
    return w.to_local(), split


def _moe_on_ranks(params, m: MoEConfig, x, act: str):
    """``moe_ffn`` under a mesh, the reference's grouped dispatch on each
    rank's groups. The G = ``dispatch_groups`` groups split over the batch
    axes where G divides (``launch/specs.py::_with_dispatch_groups`` sets G
    to the batch-shard count), else every rank routes them all. Each rank
    routes and dispatches its groups whole; the expert FFN runs on its
    model shard of the weights: of d_ff_expert in 'tensor' mode, whose
    down-projection is a partial sum over the model axis, of the experts
    in 'expert' mode, whose outputs are gathered over the model axis.
    'tensor' mode with ``combine="reduce"`` (:func:`_reduce_combine_ctx`
    and G over the batch shards: the reference's ``shard_map`` branch)
    gathers each token's partial outputs first and sums the (Tg, D) block
    over the model axis in float32, cast back; otherwise the (E, C, D)
    partial outputs are summed (in float32) before the gather combine.
    Every collective is ``sharding.compat``'s."""
    from repro_torch.sharding import compat
    from repro_torch.sharding.act import (current_ctx, from_block,
                                          shard_group_tokens)
    from repro_torch.sharding.rules import PS, placements
    ctx = current_ctx()
    if ctx is None:
        raise RuntimeError("moe_ffn on DTensors runs inside "
                           "sharding.act.activation_sharding")
    mesh, maxis = ctx.mesh, ctx.model_axis
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    t = b * s
    g = (m.dispatch_groups
         if m.dispatch_groups > 0 and t % m.dispatch_groups == 0 else 1)
    tg = t // g
    bsz = int(np.prod([ctx.mesh_sizes.get(a, 1) for a in ctx.batch_axes]))
    split_groups = bool(ctx.batch_axes) and bsz > 1 and g % bsz == 0
    bentry = (ctx.batch_axes if len(ctx.batch_axes) > 1
              else ctx.batch_axes[0]) if split_groups else None
    xp = placements(PS(bentry), mesh)
    xt = shard_group_tokens(x.reshape(g, tg, d))
    if list(xt.placements) != xp:
        xt = xt.redistribute(mesh, xp)
    xl = xt.to_local()                                   # (G_l, Tg, D)
    gl = xl.shape[0]
    msz = ctx.mesh_sizes.get(maxis, 1)
    model = compat.mesh_axis(mesh, (maxis,)) if msz > 1 else None
    router, _ = _weight_block(params["router"], mesh, maxis, 0, 1)
    names = ("w_up", "w_down") + (("w_gate",) if act == "swiglu" else ())
    if m.sharding == "tensor":
        dims = {"w_up": 2, "w_gate": 2, "w_down": 1}
    else:
        dims = {"w_up": 0, "w_gate": 0, "w_down": 0}
    w, split = {}, False
    for name in names:
        w[name], split = _weight_block(params[name], mesh, maxis,
                                       dims[name], msz)
    reduce = (m.combine == "reduce" and _reduce_combine_ctx(m) is not None
              and split_groups and split)
    COMBINE_COUNTS["reduce" if reduce else "gather"] += 1

    ml = dataclasses.replace(m, dispatch_groups=gl)
    probs, gate_vals, expert_idx, slot, keep, c = route(
        {"router": router}, ml, xl)
    flat = expert_idx.reshape(gl, tg * k)
    safe = torch.where(keep, slot, c - 1).long()
    token = torch.arange(tg, device=xl.device).repeat_interleave(k)
    e_l = w["w_up"].shape[0]
    out = []
    for gi in range(gl):
        buf = _dispatch(xl[gi], flat[gi], safe[gi], keep[gi], token, e, c)
        if m.sharding == "tensor":
            ob = _expert_outputs(w, buf, act, x.dtype)   # partial if split
            if reduce:
                part = _combine(ob, flat[gi], safe[gi], keep[gi],
                                gate_vals[gi], k, x.dtype)
                out.append(compat.psum(part.float(), model).to(x.dtype))
                continue
            if split:
                ob = compat.psum(ob.float(), model).to(x.dtype)
        else:
            e0 = model.index * e_l if split else 0
            ob = _expert_outputs(w, buf[e0:e0 + e_l], act, x.dtype)
            if split:
                rows = compat.gather_rows([ob.reshape(e_l, -1)],
                                          [e_l] * msz, model)[0]
                ob = rows.reshape(e, c, d)
        out.append(_combine(ob, flat[gi], safe[gi], keep[gi], gate_vals[gi],
                            k, x.dtype))
    outl = torch.stack(out)
    y = from_block(outl, mesh, xp, (g, tg, d))
    y = shard_group_tokens(y).reshape(b, s, d)

    # the aux means over every token: this rank's sums, summed over the
    # batch shards where the groups split
    sums = torch.cat([probs.reshape(-1, e).sum(0),
                      F.one_hot(expert_idx[..., 0].reshape(-1), e).sum(0)
                      .float(), keep.sum().float().reshape(1)])
    if split_groups:
        sums = compat.psum(sums, compat.mesh_axis(mesh, ctx.batch_axes))
    inv_t = float(np.float32(1) / np.float32(t))
    me, ce = sums[:e] * inv_t, sums[e:2 * e] * inv_t
    kept = sums[2 * e] * float(np.float32(1) / np.float32(t * k))
    aux = {"load_balance_loss": e * torch.sum(me * ce) * m.router_aux_weight,
           "drop_fraction": 1.0 - kept}
    return y, aux
