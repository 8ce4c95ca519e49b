"""Parameter specs, the parameter container, and the primitive layers.

Counterpart of ``repro/models/layers.py``. A module's ``*_spec`` gives its
parameters as a tree of ``P`` (shape, initializer, dtype) under the
reference's names; ``init_params`` makes a ``Params`` tree of them (an
``nn.Module`` per subtree, an ``nn.Parameter`` per leaf, no gradients) and
fills it from a ``torch.Generator``. A ``Params`` reads like the
reference's dict (``params["attn"]["wq"]``), so the apply functions keep
the reference's form ``apply(params, ..., x)``.

The reference seeds each leaf with ``fold_in(key, hash(name))``, which
depends on Python's per-process string hash, so its weights cannot be
reproduced across processes; the port draws its leaves in spec order from
one generator instead, and the tests carry the reference's weights across
(``convert.lm_params_from_arrays``).

Every ``P`` carries the reference's logical axis names (``axes``, one a
dim): ``spec_axes`` gives the tree of them, which ``sharding/rules.py``
resolves into a mesh's placements. The vocabulary is the reference's:
'vocab', 'embed', 'embed_table' (the embedding's model dim, never FSDP),
'ffn', 'heads', 'kv_heads', 'head_dim', 'expert', 'expert_ffn',
'expert_router', 'state', 'conv', 'layers' (the reference's stacking
axis: ``stack_spec``), or None. The port keeps its layers in a list, so
its own specs carry no 'layers' dim; ``transformer.param_axes`` gives the
reference's nesting.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class P:
    """Parameter spec: shape, logical axes, initializer and dtype."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | fan_in
    scale: float = 0.02
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in length")


def _flatten_spec(spec, prefix=()):
    items = spec.items() if isinstance(spec, dict) else enumerate(spec)
    out = []
    for k, v in items:
        path = prefix + (k,)
        out.extend([(path, v)] if isinstance(v, P) else _flatten_spec(v, path))
    return out


def _map_spec(spec, fn):
    """``fn`` of every leaf of a spec tree (dicts and lists), same nesting."""
    if isinstance(spec, list):
        return [_map_spec(s, fn) for s in spec]
    return {k: fn(v) if isinstance(v, P) else _map_spec(v, fn)
            for k, v in spec.items()}


def spec_axes(spec):
    """The logical-axes tree of a spec (same nesting as the params)."""
    return _map_spec(spec, lambda p: p.axes)


def stack_spec(spec, n: int):
    """Prepend a 'layers' axis of length ``n`` to every leaf of a spec (the
    reference's scan stacking)."""
    return _map_spec(spec, lambda p: dataclasses.replace(
        p, shape=(n,) + p.shape, axes=("layers",) + p.axes))


def spec_param_count(spec) -> int:
    return sum(math.prod(p.shape) for _, p in _flatten_spec(spec))


def meta(shape, dtype) -> torch.Tensor:
    """A shape-only stand-in: a tensor on the ``meta`` device (no storage),
    the reference's ``jax.ShapeDtypeStruct``."""
    return torch.empty(shape, dtype=dtype, device="meta")


def zeros_of(spec, device):
    """Zeros on ``device`` in the shapes and dtypes of a tree of ``meta``
    tensors (dicts and lists)."""
    if isinstance(spec, list):
        return [zeros_of(s, device) for s in spec]
    if isinstance(spec, dict):
        return {name: zeros_of(s, device) for name, s in spec.items()}
    return torch.zeros(spec.shape, dtype=spec.dtype, device=device)


class Params(nn.Module):
    """A subtree of parameters: children by the spec's names, read as
    ``params[name]``. A list in the spec becomes an ``nn.ModuleList``."""

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def build_params(spec, leaf: Callable[[Tuple, P], torch.Tensor], prefix=()):
    """The ``Params`` tree of ``spec``, each leaf the tensor ``leaf(path,
    p)`` gives (path: the names and list indices from the root)."""
    if isinstance(spec, list):
        return nn.ModuleList(build_params(s, leaf, prefix + (i,))
                             for i, s in enumerate(spec))
    node = Params()
    for name, s in spec.items():
        path = prefix + (name,)
        if isinstance(s, P):
            t = leaf(path, s)
            if tuple(t.shape) != s.shape or t.dtype != s.dtype:
                raise ValueError(f"{'/'.join(map(str, path))}: expected "
                                 f"{s.dtype} {s.shape}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
            node.register_parameter(name, nn.Parameter(t, requires_grad=False))
        else:
            node.add_module(name, build_params(s, leaf, path))
    return node


def abstract_params(spec) -> Params:
    """The spec's ``Params`` with every leaf on ``meta``: parameters of any
    size without an allocation, which the model's functions take as they
    take real ones."""
    return build_params(spec, lambda _, p: meta(p.shape, p.dtype))


def init_leaf(p: P, generator: torch.Generator, device) -> torch.Tensor:
    """One leaf drawn from ``generator`` (in float32, then cast)."""
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=p.dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=p.dtype, device=device)
    if p.init == "fan_in":
        scale = 1.0 / math.sqrt(max(p.shape[0] if p.shape else 1, 1))
    elif p.init == "normal":
        scale = p.scale
    else:
        raise ValueError(f"unknown initializer {p.init!r}")
    x = torch.randn(p.shape, generator=generator, device=device)
    return (x * scale).to(p.dtype)


def init_params(spec, generator: torch.Generator, device) -> Params:
    """Materialize ``spec`` on ``device``, leaves drawn in spec order from
    ``generator`` (which must live on ``device``)."""
    return build_params(spec, lambda _, p: init_leaf(p, generator, device))


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int, dtype=torch.float32):
    return {"scale": P((d,), ("embed",), init="ones", dtype=dtype)}


def rmsnorm(params, x, eps: float = 1e-6, sum_over=None, width=None):
    """RMS norm over the last dim; with ``sum_over``, ``x`` holds a block
    of a norm over ``width`` channels (a per-rank body's share of a split
    width) and ``sum_over`` sums the block's squares over the ranks that
    hold the others."""
    dt = x.dtype
    xf = x.float()
    if sum_over is None:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        var = sum_over(torch.sum(xf * xf, dim=-1, keepdim=True)) / width
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def layernorm_spec(d: int, dtype=torch.float32):
    return {"scale": P((d,), ("embed",), init="ones", dtype=dtype),
            "bias": P((d,), ("embed",), init="zeros", dtype=dtype)}


def layernorm(params, x, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(dt)


def mlp_spec(d_model: int, d_ff: int, act: str, dtype=torch.float32):
    if act == "swiglu":
        return {"w_gate": P((d_model, d_ff), ("embed", "ffn"),
                            init="fan_in", dtype=dtype),
                "w_up": P((d_model, d_ff), ("embed", "ffn"), init="fan_in",
                          dtype=dtype),
                "w_down": P((d_ff, d_model), ("ffn", "embed"),
                            init="fan_in", dtype=dtype)}
    return {"w_up": P((d_model, d_ff), ("embed", "ffn"), init="fan_in",
                      dtype=dtype),
            "b_up": P((d_ff,), ("ffn",), init="zeros", dtype=dtype),
            "w_down": P((d_ff, d_model), ("ffn", "embed"), init="fan_in",
                        dtype=dtype),
            "b_down": P((d_model,), ("embed",), init="zeros", dtype=dtype)}


def wcast(w, x):
    """Apply-time weight cast: matmuls run in the activation dtype."""
    return w.to(x.dtype)


def mlp(params, x, act: str):
    if act == "swiglu":
        g = x @ wcast(params["w_gate"], x)
        u = x @ wcast(params["w_up"], x)
        h = F.silu(g.float()).to(x.dtype) * u
        return h @ wcast(params["w_down"], x)
    h = x @ wcast(params["w_up"], x) + params["b_up"].to(x.dtype)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ wcast(params["w_down"], x) + params["b_down"].to(x.dtype)


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``
    (``F.softplus`` switches to x above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def causal_conv(params, x, conv_state=None):
    """Causal depthwise conv of width K = ``conv_w.shape[0]`` over
    (B, S, C), plus ``conv_b``, the recurrent blocks' shared front: the
    last K - 1 input rows before it are ``conv_state`` (B, K - 1, C) in
    decode, zeros otherwise. Returns (out, the last K - 1 input rows), the
    taps summed in order as the reference's ``sum`` does."""
    w = wcast(params["conv_w"], x)                  # (K, C)
    k = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((x.shape[0], k - 1, x.shape[-1]),
                                 dtype=x.dtype, device=x.device)
    full = torch.cat([conv_state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = 0
    for i in range(k):
        out = out + full[:, i:i + s] * w[i]
    return out + wcast(params["conv_b"], x), full[:, -(k - 1):].clone()


def embedding_spec(vocab: int, d_model: int, dtype=torch.float32):
    # the model dim is never FSDP ('embed_table' maps to no mesh axis): the
    # table is vocab-sharded over 'model' already, and a second sharding
    # turns every lookup into a full-batch all-reduce (the reference's note)
    return {"table": P((vocab, d_model), ("vocab", "embed_table"),
                       init="normal", scale=0.02,
                       dtype=dtype)}


def embed(params, tokens, compute_dtype):
    """The table's rows at ``tokens``. On DTensors a vocab-sharded table
    is looked up on each shard and the partial rows summed here (the
    vocab-parallel embedding's all-reduce); under autograd, whose
    backward DTensor lacks for that lookup, the table is gathered first
    (its gradient reduce-scattered back)."""
    from repro_torch.sharding.act import is_dtensor, resolve_partial
    table = params["table"].to(compute_dtype)
    if is_dtensor(table) and table.requires_grad:
        from torch.distributed.tensor import Replicate
        table = table.redistribute(table.device_mesh,
                                   [Replicate()] * table.device_mesh.ndim)
    return resolve_partial(F.embedding(tokens.long(), table))


def unembed(params, x):
    # logits in f32
    return x.float() @ params["table"].float().T


def positional_embedding_spec(max_len: int, d_model: int, dtype=torch.float32):
    """Learned positions (whisper's decoder): a (max_len, d_model) table."""
    return {"pos": P((max_len, d_model), (None, "embed"), init="normal",
                     scale=0.02,
                     dtype=dtype)}
