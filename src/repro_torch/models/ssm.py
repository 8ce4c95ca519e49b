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


def ssm_forward(params, s: SSMConfig, d_model: int, x, *,
                compute_dtype=torch.bfloat16, return_state: bool = False):
    """The full-sequence block: x (B, S, d_model) -> the same shape; with
    ``return_state`` also the decode state {"ssm", "conv"} after the last
    position (the fused prefill)."""
    d_inner, h, _ = ssm_dims(d_model, s)
    bsz, seq, _ = x.shape
    gn = s.n_groups * s.d_state
    z, xbc_raw, dt = _split_proj(params, s, d_model, x)
    xbc, conv_state = _conv(params, xbc_raw)
    xs = xbc[..., :d_inner].reshape(bsz, seq, h, s.head_dim)
    Bm = xbc[..., d_inner:d_inner + gn].reshape(bsz, seq, s.n_groups,
                                                s.d_state)
    Cm = xbc[..., d_inner + gn:].reshape(bsz, seq, s.n_groups, s.d_state)
    dt = softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    y, final = ssd_chunked(xs, dt, A, Bm, Cm, s.chunk_size)
    y = y + params["D"][None, None, :, None].to(y.dtype) * xs
    y = y.reshape(bsz, seq, d_inner)
    y = y * F.silu(z.float()).to(y.dtype)
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
    (new tensors; the caller decides where they live)."""
    d_inner, h, _ = ssm_dims(d_model, s)
    bsz = x.shape[0]
    gn = s.n_groups * s.d_state
    z, xbc, dt = _split_proj(params, s, d_model, x)
    xbc, conv_state = _conv(params, xbc, conv_state=state["conv"])
    xs = xbc[..., :d_inner].reshape(bsz, h, s.head_dim)
    rep = h // s.n_groups
    Bm = xbc[:, 0, d_inner:d_inner + gn].reshape(
        bsz, s.n_groups, s.d_state).repeat_interleave(rep, dim=1)
    Cm = xbc[:, 0, d_inner + gn:].reshape(
        bsz, s.n_groups, s.d_state).repeat_interleave(rep, dim=1)
    dt = softplus(dt[:, 0].float() + params["dt_bias"])          # (B, H)
    A = -torch.exp(params["A_log"])

    dA = torch.exp(dt * A[None, :])
    xf = xs.float() * dt[..., None]                               # (B, H, P)
    new_ssm = (state["ssm"] * dA[..., None, None]
               + xf[..., :, None] * Bm.float()[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", new_ssm, Cm.float())
    y = y + params["D"][None, :, None] * xs.float()
    y = y.reshape(bsz, 1, d_inner).to(compute_dtype)
    y = y * F.silu(z.float()).to(y.dtype)
    y = rmsnorm(params["norm"], y)
    return y @ params["w_out"].to(y.dtype), {"ssm": new_ssm,
                                             "conv": conv_state}
