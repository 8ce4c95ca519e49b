"""Tree optimizers: SGD, SGD with momentum, AdamW.

Counterpart of ``repro/optim/optimizers.py``, with the same functional
API: ``opt.init(params) -> state``; ``opt.update(grads, state, params,
step) -> (new_params, new_state)``. Every update is element-wise, so it
broadcasts over the gossip peer axis (the leading stacked dim of per-peer
parameters), and each leaf keeps the reference's arithmetic and dtypes:
float32 math, the result cast back to the parameter's dtype, SGD-momentum's
buffer in bfloat16, AdamW's moments in float32.

Two differences of form, none of value:

* ``update`` writes the new values into ``params`` and ``state`` in place
  and returns those same trees: at qwen3-1.7b's width four peers' AdamW
  state is 23 GB, and a second copy would not fit beside it on one card.
* A leaf is updated in slices of at most ``CHUNK`` elements, so the float32
  temporaries of a 2.5 GB embedding leaf stay small; the ops are
  element-wise, so the slices give the bits of the whole-leaf update.

The global-norm clip spans the whole tree it is given: in the gossip step
that is every peer's gradients together, as in the reference. On a peer
mesh each rank holds one peer's, and ``update``'s ``reduce_sq`` sums the
squares over the peers before the root.

Under a mesh (``launch/specs.py``) the leaves are DTensors: the state is
made at the parameters' placements, a gradient is resharded to its
parameter's placements (the data-parallel all-reduce or reduce-scatter),
and the element-wise update runs on each rank's local shards in place; a
leaf's squares are summed over its shards for the clip.
"""
from __future__ import annotations

from typing import Callable, Iterator, NamedTuple, Tuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map

# elements of a leaf updated at a time
CHUNK = 1 << 26


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    name: str


def _local(*tensors):
    """The tensors as they are, or, when the first (a parameter) is a
    DTensor, each one's local shard at the parameter's placements (a
    gradient resharded to them first; the state is made at them)."""
    from torch.distributed.tensor import DTensor
    p = tensors[0]
    if not isinstance(p, DTensor):
        return tensors
    out = []
    for t in tensors:
        if list(t.placements) != list(p.placements):
            t = t.redistribute(p.device_mesh, p.placements)
        out.append(t.to_local())
    return tuple(out)


def _slices(*tensors) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching flat slices of same-shaped contiguous tensors (of the
    local shards of DTensors)."""
    flat = [t.view(-1) for t in _local(*tensors)]
    for lo in range(0, flat[0].numel(), CHUNK):
        yield tuple(f[lo:lo + CHUNK] for f in flat)


def _global_norm(tree, reduce_sq=None) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, DTensor):
            total = total + torch.sum(torch.square(x.float())).full_tensor()
            continue
        total = total + sum(torch.sum(torch.square(c.float()))
                            for (c,) in _slices(x))
    total = torch.as_tensor(total, dtype=torch.float32)
    if reduce_sq is not None:
        total = reduce_sq(total)
    return torch.sqrt(total)


def _clip_scale(grads, max_norm: float, reduce_sq=None):
    """``min(1, max_norm / max(|g|, 1e-9))`` as a 0-d float32 tensor, or
    None when clipping is off. ``reduce_sq`` sums the squares of every
    peer's gradients when each rank holds one peer's (the peer mesh)."""
    if max_norm <= 0:
        return None
    g = torch.clamp(_global_norm(grads, reduce_sq), min=1e-9)
    # a true division: ``number / tensor`` multiplies by the reciprocal
    return torch.clamp(torch.div(torch.full_like(g, max_norm), g), max=1.0)


def _grad32(g, scale):
    """A gradient slice in float32, clipped as the reference clips: the
    product rounded back to the gradient's dtype first."""
    if scale is None:
        return g.float()
    return (g.float() * scale).to(g.dtype).float()


def _zeros(params, dtype=None):
    from torch.distributed.tensor import DTensor

    def zeros(p):
        if isinstance(p, DTensor):
            return torch.zeros_like(p, dtype=dtype or p.dtype)
        return torch.zeros(p.shape, dtype=dtype or p.dtype, device=p.device)
    return tree_map(zeros, params)


def sgd(lr_schedule, grad_clip: float = 0.0) -> Optimizer:
    def init(params):
        return {}

    @torch.no_grad()
    def update(grads, state, params, step, reduce_sq=None):
        scale = _clip_scale(grads, grad_clip, reduce_sq)
        lr = lr_schedule(step)
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            for pc, gc in _slices(p, g):
                pc.copy_(pc - lr * _grad32(gc, scale))
        return params, state

    return Optimizer(init, update, "sgd")


def sgd_momentum(lr_schedule, momentum: float = 0.9, grad_clip: float = 0.0,
                 momentum_dtype=torch.bfloat16) -> Optimizer:
    def init(params):
        return {"m": _zeros(params, momentum_dtype)}

    @torch.no_grad()
    def update(grads, state, params, step, reduce_sq=None):
        scale = _clip_scale(grads, grad_clip, reduce_sq)
        lr = lr_schedule(step)
        for p, g, m in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(state["m"])):
            for pc, gc, mc in _slices(p, g, m):
                mc.copy_(momentum * mc.float() + _grad32(gc, scale))
                pc.copy_(pc - lr * mc.float())
        return params, state

    return Optimizer(init, update, "sgdm")


def adamw(lr_schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, grad_clip: float = 1.0) -> Optimizer:
    def init(params):
        return {"m": _zeros(params, torch.float32),
                "v": _zeros(params, torch.float32)}

    @torch.no_grad()
    def update(grads, state, params, step, reduce_sq=None):
        scale = _clip_scale(grads, grad_clip, reduce_sq)
        lr = lr_schedule(step)
        if isinstance(step, torch.Tensor):
            t = step.to(torch.float32) + 1.0
        else:
            t = float(step) + 1.0
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            for pc, gc, mc, vc in _slices(p, g, m, v):
                g32 = _grad32(gc, scale)
                mc.copy_(b1 * mc + (1 - b1) * g32)
                vc.copy_(b2 * vc + (1 - b2) * torch.square(g32))
                u = (mc / bc1) / (torch.sqrt(vc / bc2) + eps)
                p32 = pc.float()
                u = u + weight_decay * p32
                pc.copy_(p32 - lr * u)
        return params, state

    return Optimizer(init, update, "adamw")


def make_optimizer(name: str, lr_schedule, *, grad_clip: float = 1.0,
                   weight_decay: float = 0.1) -> Optimizer:
    if name == "sgd":
        return sgd(lr_schedule, grad_clip)
    if name == "sgdm":
        return sgd_momentum(lr_schedule, grad_clip=grad_clip)
    if name == "adamw":
        return adamw(lr_schedule, grad_clip=grad_clip,
                     weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name!r}")
