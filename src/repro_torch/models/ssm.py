"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060].

Counterpart of ``repro/models/ssm.py``. The full-sequence pass (forward
and fused prefill) is the chunked dual form: a quadratic, attention-like
term inside chunks of ``chunk_size`` and a linear recurrence between
chunks through the chunk-level ``segsum`` decay matrix; decode is the
one-token recurrence on an O(1) state. The reference writes the chunked
form as four-operand einsums and leaves their order to XLA; here each is
contracted pair by pair in a fixed order, so that no intermediate is
larger than (b, c, h, l, l) — an order that let (b, c, l, s, h, n) appear
would not fit the card at full width. The decay exponents stay in
float32, as the reference keeps them.

``jax.nn.softplus`` is ``logaddexp(x, 0)`` (``layers.softplus``);
``F.softplus`` switches to x above 20.

On DTensors (a step on a mesh) the block runs as a per-rank body on this
rank's heads (``sharding/act.py``): the input projection ``w_in`` is one
concatenated ``[z | xBC | dt]`` matrix whose columns the rules shard
over ``model`` with boundaries inside its segments, so its product is
gathered whole over ``model`` first (B x S x 2·d_inner + 2·G·N + H
values a layer) and each rank slices its heads' z, x and dt columns and
the whole B and C; the depthwise conv, the SSD scan and the gated norm
(its sum of squares summed over ``model``) run on the local heads, and
the output projection takes the heads' rows. The small leaves (``A_log``,
``D``, ``dt_bias``, the conv and the norm), whole or sharded, are
gathered and sliced to the rank's heads and channels. The decode state
keeps the heads' SSD state and the whole raw conv window.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import SSMConfig
from repro_torch.models.layers import (P, causal_conv, meta, rmsnorm,
                                       rmsnorm_spec, softplus, zeros_of)


def ssm_dims(d_model: int, s: SSMConfig):
    d_inner = s.expand * d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_dim


def ssm_spec(d_model: int, s: SSMConfig, dtype=torch.float32) -> Dict:
    d_inner, h, conv_dim = ssm_dims(d_model, s)
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + h
    return {
        "w_in": P((d_model, d_in_proj), ("embed", "ffn"), init="fan_in",
                  dtype=dtype),
        "conv_w": P((s.d_conv, conv_dim), ("conv", "ffn"), init="fan_in",
                    dtype=dtype),
        "conv_b": P((conv_dim,), ("ffn",), init="zeros", dtype=dtype),
        "A_log": P((h,), ("heads",), init="zeros", dtype=torch.float32),
        "D": P((h,), ("heads",), init="ones", dtype=torch.float32),
        "dt_bias": P((h,), ("heads",), init="zeros", dtype=torch.float32),
        "norm": rmsnorm_spec(d_inner, dtype),
        "w_out": P((d_inner, d_model), ("ffn", "embed"), init="fan_in",
                   dtype=dtype),
    }


def _segsum(x):
    """x (..., T) -> (..., T, T): out[..., i, j] = sum of x[j+1..i] on and
    below the diagonal, -inf above it: SSD's decay matrix."""
    t = x.shape[-1]
    xe = x[..., None].expand(*x.shape, t)          # xe[..., d, e] = x[d]
    ones = torch.ones((t, t), dtype=torch.bool, device=x.device)
    xe = torch.where(torch.tril(ones, diagonal=-1), xe, 0.0)
    seg = torch.cumsum(xe, dim=-2)
    return torch.where(torch.tril(ones), seg, float("-inf"))


def _split_proj(params, s: SSMConfig, d_model: int, x):
    d_inner, _, conv_dim = ssm_dims(d_model, s)
    zxbcdt = x @ params["w_in"].to(x.dtype)
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:d_inner + conv_dim],
            zxbcdt[..., d_inner + conv_dim:])


def _conv(params, xbc, conv_state=None):
    """The causal conv over (B, S, conv_dim), then SiLU. Returns (out, the
    last d_conv - 1 raw rows)."""
    out, state = causal_conv(params, xbc, conv_state)
    return F.silu(out.float()).to(xbc.dtype), state


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """The SSD dual form. x (b, S, h, p); dt (b, S, h) float32 after the
    softplus; A (h,) negative; B, C (b, S, g, n). Returns y (b, S, h, p)
    and the final state (b, h, p, n). S is padded to a chunk multiple with
    dt = 0: decay exp(0) = 1 and zero input, so the state carries through
    unchanged and the padded outputs are dropped."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        pad = chunk - s % chunk

        def pad_s(t):
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        y, final = ssd_chunked(pad_s(x), pad_s(dt), A, pad_s(B), pad_s(C),
                               chunk)
        return y[:, :s], final
    c = s // chunk
    rep = h // g
    xc = x.reshape(b, c, chunk, h, p)
    dtc = dt.reshape(b, c, chunk, h)
    Bc = B.reshape(b, c, chunk, g, n).repeat_interleave(rep, dim=3)
    Cc = C.reshape(b, c, chunk, g, n).repeat_interleave(rep, dim=3)

    a = (dtc * A).float().permute(0, 1, 3, 2)       # (b, c, h, l) log decay
    a_cum = torch.cumsum(a, dim=-1)
    x_dt = xc * dtc[..., None].to(xc.dtype)         # (b, c, l, h, p)

    # 1) within chunks: (C B^T) * L, then times x_dt
    L = torch.exp(_segsum(a)).to(Cc.dtype)          # (b, c, h, l, s)
    cb = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)
    y_diag = torch.einsum("bchls,bcshp->bclhp", cb * L, x_dt)

    # 2) each chunk's final state
    decay = torch.exp(a_cum[..., -1:] - a_cum).to(Bc.dtype)   # (b, c, h, l)
    b_dec = Bc * decay.permute(0, 1, 3, 2)[..., None]          # (b,c,l,h,n)
    states = torch.einsum("bclhn,bclhp->bchpn", b_dec, x_dt)

    # 3) between chunks: the chunk-level segsum, (c + 1) x (c + 1)
    cd = F.pad(a_cum[..., -1].permute(0, 2, 1), (1, 0))      # (b, h, c+1)
    dk = torch.exp(_segsum(cd)).to(states.dtype)
    states_pad = F.pad(states, (0, 0, 0, 0, 0, 0, 1, 0))     # (b,c+1,h,p,n)
    all_states = torch.einsum("bhzc,bchpn->bzhpn", dk, states_pad)
    init_states, final = all_states[:, :-1], all_states[:, -1]

    # 4) the carried-in state's share of each position
    out_decay = torch.exp(a_cum).to(Cc.dtype)       # (b, c, h, l)
    y_off = torch.einsum("bclhn,bchpn->bclhp", Cc, init_states)
    y_off = y_off * out_decay.permute(0, 1, 3, 2)[..., None]
    return (y_diag + y_off).reshape(b, s, h, p), final


def _heads(s: SSMConfig, p, xs, z, dt, B, C, ssm_state, compute_dtype):
    """The mixer after the conv on a block of heads, shared by one device
    (all heads) and a rank's body (its heads): the SSD scan over the
    sequence (``ssm_state`` None) or the one-token recurrence from
    ``ssm_state`` (b, hl, P, N), then the D skip and the gate. xs
    (b, S, hl, P); z (b, S, hl·P); dt (b, S, hl) before the softplus; B, C
    (b, S, g, N) with g dividing hl; ``p`` holds the heads' ``dt_bias``,
    ``A_log`` and ``D``. Returns (y (b, S, hl·P) before the norm, the
    final state)."""
    b, seq, hl, hp = xs.shape
    dt = softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    if ssm_state is None:
        y, final = ssd_chunked(xs, dt, A, B, C, s.chunk_size)
        y = y + p["D"][None, None, :, None].to(y.dtype) * xs
    else:
        rep = hl // B.shape[2]
        Bm = B[:, 0].repeat_interleave(rep, dim=1)               # (b, hl, N)
        Cm = C[:, 0].repeat_interleave(rep, dim=1)
        dA = torch.exp(dt[:, 0] * A[None, :])
        xf = xs[:, 0].float() * dt[:, 0, :, None]                # (b, hl, P)
        final = (ssm_state * dA[..., None, None]
                 + xf[..., :, None] * Bm.float()[:, :, None, :])
        y = torch.einsum("bhpn,bhn->bhp", final, Cm.float())
        y = (y + p["D"][None, :, None] * xs[:, 0].float()).to(compute_dtype)
    y = y.reshape(b, seq, hl * hp)
    return y * F.silu(z.float()).to(y.dtype), final


def _on_ranks(params, s: SSMConfig, d_model: int, x, state,
              compute_dtype, return_state: bool):
    """:func:`ssm_forward` (``state`` None) or :func:`ssm_step` on
    DTensors: a per-rank body on this rank's heads (the module note)."""
    from torch.distributed.tensor import Replicate
    from repro_torch.sharding import act
    mesh = x.device_mesh
    d_inner, h, conv_dim = ssm_dims(d_model, s)
    g, n, p = s.n_groups, s.d_state, s.head_dim
    gn = g * n
    bsz, seq, _ = x.shape
    w, me = act.model_share(x, h)
    hl = h // w
    h0, c0 = me * hl, me * hl * p
    pl_all = act.body_placements(x)
    pl_out = act.body_placements(x, 2, w > 1)
    pl_head = act.body_placements(x, 1, w > 1)
    rep = [Replicate()] * mesh.ndim

    def whole(t):
        return act.body_input(t, rep, pl_out)

    zx = act.body_input(x @ params["w_in"].to(x.dtype), pl_all, pl_out)
    z = zx[..., c0:c0 + hl * p]
    raw = zx[..., d_inner:d_inner + conv_dim]
    dt = zx[..., d_inner + conv_dim + h0:d_inner + conv_dim + h0 + hl]
    cols = torch.cat([torch.arange(c0, c0 + hl * p),
                      torch.arange(d_inner, conv_dim)]).to(x.device)
    conv_w, conv_b = whole(params["conv_w"]), whole(params["conv_b"])
    k = conv_w.shape[0]
    prev = (torch.zeros((raw.shape[0], k - 1, conv_dim), dtype=raw.dtype,
                        device=raw.device) if state is None else
            act.body_input(state["conv"], pl_all, pl_out).to(raw.dtype))
    xbc, _ = _conv({"conv_w": conv_w[:, cols], "conv_b": conv_b[cols]},
                   raw[..., cols], prev[..., cols])
    window = torch.cat([prev, raw], dim=1)[:, -(k - 1):].clone()
    bl = xbc.shape[0]
    xs = xbc[..., :hl * p].reshape(bl, seq, hl, p)

    def per_head(t):                   # (bl, seq, g, n) -> this rank's heads
        return t.reshape(bl, seq, g, n).repeat_interleave(
            h // g, dim=2)[:, :, h0:h0 + hl]
    heads = {k_: whole(params[k_])[h0:h0 + hl]
             for k_ in ("dt_bias", "A_log", "D")}
    y, final = _heads(
        s, heads, xs, z, dt, per_head(xbc[..., hl * p:hl * p + gn]),
        per_head(xbc[..., hl * p + gn:]),
        None if state is None else act.body_input(state["ssm"], pl_head,
                                                  pl_out),
        compute_dtype)
    # the gated norm over all d_inner channels: the squares summed over
    # the ranks' heads
    scale = {"scale": whole(params["norm"]["scale"])[c0:c0 + hl * p]}
    y = rmsnorm(scale, y, width=d_inner, sum_over=None if w == 1 else
                lambda ss: act.body_sum(ss, mesh))
    y = act.from_block(y, mesh, pl_out, (bsz, seq, d_inner))
    out = y @ params["w_out"].to(y.dtype)
    if state is None and not return_state:
        return out
    new = {"ssm": act.from_block(final.float(), mesh, pl_head,
                                 (bsz, h, p, n)),
           "conv": act.from_block(window.to(compute_dtype), mesh, pl_all,
                                  (bsz, k - 1, conv_dim))}
    return out, new


def _parts(params, s: SSMConfig, d_model: int, x, conv_state=None):
    """One device's front: the projection, its split and the conv.
    Returns (xs (B, S, H, P), z, dt, B, C (B, S, G, N), the conv's new
    window)."""
    d_inner, h, _ = ssm_dims(d_model, s)
    bsz, seq, _ = x.shape
    gn = s.n_groups * s.d_state
    z, xbc, dt = _split_proj(params, s, d_model, x)
    xbc, window = _conv(params, xbc, conv_state)
    xs = xbc[..., :d_inner].reshape(bsz, seq, h, s.head_dim)
    Bm = xbc[..., d_inner:d_inner + gn].reshape(bsz, seq, s.n_groups,
                                                s.d_state)
    Cm = xbc[..., d_inner + gn:].reshape(bsz, seq, s.n_groups, s.d_state)
    return xs, z, dt, Bm, Cm, window


def ssm_forward(params, s: SSMConfig, d_model: int, x, *,
                compute_dtype=torch.bfloat16, return_state: bool = False):
    """The full-sequence block: x (B, S, d_model) -> the same shape; with
    ``return_state`` also the decode state {"ssm", "conv"} after the last
    position (the fused prefill). On DTensors a per-rank body on this
    rank's heads (the module note)."""
    from repro_torch.sharding.act import is_dtensor
    if is_dtensor(x):
        return _on_ranks(params, s, d_model, x, None, compute_dtype,
                         return_state)
    xs, z, dt, Bm, Cm, conv_state = _parts(params, s, d_model, x)
    y, final = _heads(s, params, xs, z, dt, Bm, Cm, None, compute_dtype)
    y = rmsnorm(params["norm"], y)
    out = y @ params["w_out"].to(y.dtype)
    if return_state:
        # decode carries the raw (pre-activation) conv window of xBC rows
        return out, {"ssm": final.float(),
                     "conv": conv_state.to(compute_dtype)}
    return out


def ssm_state_spec(batch: int, d_model: int, s: SSMConfig,
                   dtype) -> Dict[str, torch.Tensor]:
    """The decode state as ``meta`` tensors: ``ssm`` (B, H, P, N) float32
    and ``conv`` (B, d_conv - 1, conv_dim) in ``dtype``."""
    _, h, conv_dim = ssm_dims(d_model, s)
    return {"ssm": meta((batch, h, s.head_dim, s.d_state), torch.float32),
            "conv": meta((batch, s.d_conv - 1, conv_dim), dtype)}


def init_ssm_state(batch: int, d_model: int, s: SSMConfig, dtype,
                   device=None) -> Dict[str, torch.Tensor]:
    """The zero decode state (:func:`ssm_state_spec`) on ``device``."""
    return zeros_of(ssm_state_spec(batch, d_model, s, dtype), device)


def ssm_step(params, s: SSMConfig, d_model: int, x, state, *,
             compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict]:
    """One token: x (B, 1, d_model). Returns the output and the new state
    (new tensors; the caller decides where they live). On DTensors a
    per-rank body on this rank's heads (the module note)."""
    from repro_torch.sharding.act import is_dtensor
    if is_dtensor(x):
        return _on_ranks(params, s, d_model, x, state, compute_dtype, True)
    xs, z, dt, Bm, Cm, conv_state = _parts(params, s, d_model, x,
                                           state["conv"])
    y, new_ssm = _heads(s, params, xs, z, dt, Bm, Cm, state["ssm"],
                        compute_dtype)
    y = rmsnorm(params["norm"], y)
    return y @ params["w_out"].to(y.dtype), {"ssm": new_ssm,
                                             "conv": conv_state}
