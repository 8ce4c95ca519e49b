"""Activation sharding constraints and the per-rank bodies.

Counterpart of ``repro/sharding/act.py``. The reference pins the
activation layout at module boundaries with ``with_sharding_constraint``;
here an activation under a mesh is a DTensor, and a constraint is
``x.redistribute(mesh, placements)`` (a ``Partial`` sum resolves there:
the tensor-parallel all-reduce, or a reduce-scatter). The context is set
by the step builders (``launch/specs.py``) around a step; model code
calls the ``shard_*`` helpers, which are the identity when no context is
active, and on a plain tensor, as the reference's are off a mesh. Inside
the context a plain tensor that meets a DTensor (positions, masks,
constants) counts as replicated, as a constant is in the reference's
trace. Under the gossip optimizer the peers are the ranks of the peer
axis, and the inner context uses ``batch_axes=()``.

Where the reference leaves GSPMD a ``shard_map`` (the kernel calls, the
MoE reduce combine) or writes into a sharded cache, the port runs a
per-rank body on the local shards: :func:`local_block` gives a DTensor's
local tensor after resharding it so that only the dims a body can take
stay sharded, :func:`from_block` makes a body's result a DTensor again,
and :func:`write_into` writes a value into a DTensor's shards in place
(slicing a sharded dim of a DTensor and writing into the slice writes
into a temporary, and is lost without an error).

The recurrent mixers (``models/ssm.py``, ``models/rglru.py``) run their
scans, convolutions and gates in such a body on the heads and channels
of this rank's share of the model axis (:func:`model_share`), with
:func:`body_placements` and :func:`body_input` taking the local inputs:
their gradients come back through ``to_local``/``from_local``, summed
over the ranks where a whole copy fed different work, and a norm over
the split width sums its partial squares with :func:`body_sum`.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.sharding.rules import PS, mesh_sizes, placements


@dataclass
class _ActCtx:
    mesh_sizes: dict
    batch_axes: Tuple[str, ...]
    model_axis: str = "model"
    mesh: object = None


_CTX: Optional[_ActCtx] = None


@contextlib.contextmanager
def activation_sharding(mesh, batch_axes: Tuple[str, ...],
                        model_axis: str = "model"):
    """The activation layout of a step on ``mesh`` (a ``DeviceMesh``): the
    batch over ``batch_axes``, heads, the FFN and the vocab over
    ``model_axis``."""
    from torch.distributed.tensor.experimental import implicit_replication
    global _CTX
    prev = _CTX
    _CTX = _ActCtx(mesh_sizes(mesh), tuple(batch_axes), model_axis, mesh)
    try:
        with implicit_replication():
            yield
    finally:
        _CTX = prev


def current_ctx() -> Optional[_ActCtx]:
    """The active activation-sharding context (mesh + axis layout), or
    None. Used by the modules that run per-rank bodies."""
    return _CTX


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _axis_size(axes) -> int:
    if _CTX is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(_CTX.mesh_sizes.get(a, 1) for a in axes)


def _constrain(x, spec_entries):
    if not is_dtensor(x):
        return x
    want = placements(PS(*spec_entries), _CTX.mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(_CTX.mesh, want)


def _batch_entry():
    ba = _CTX.batch_axes
    if not ba:
        return None
    return ba if len(ba) > 1 else ba[0]


def shard_activations(x):
    """(B, S, D) or (B, S): batch over the batch axes, rest replicated."""
    if _CTX is None:
        return x
    b = x.shape[0]
    entry = _batch_entry()
    if entry is None or b % _axis_size(entry) != 0:
        return x
    return _constrain(x, [entry] + [None] * (x.ndim - 1))


def shard_logits(x):
    """(B, S, V) or (B, C, V): batch over batch axes, vocab over model."""
    if _CTX is None:
        return x
    entries = [None] * x.ndim
    entry = _batch_entry()
    if entry is not None and x.shape[0] % _axis_size(entry) == 0:
        entries[0] = entry
    if x.shape[-1] % _axis_size(_CTX.model_axis) == 0:
        entries[-1] = _CTX.model_axis
    return _constrain(x, entries)


def shard_heads(x, head_dim_index: int = 2):
    """(B, S, H, hd): batch over batch axes, heads over model if divisible."""
    if _CTX is None:
        return x
    entries = [None] * x.ndim
    entry = _batch_entry()
    if entry is not None and x.shape[0] % _axis_size(entry) == 0:
        entries[0] = entry
    if x.shape[head_dim_index] % _axis_size(_CTX.model_axis) == 0:
        entries[head_dim_index] = _CTX.model_axis
    return _constrain(x, entries)


def shard_expert_buffer(buf, moe_sharding: str):
    """(G, E, C, D) grouped dispatch buffer (or (E, C, D)): groups over
    the batch axes, experts over model in 'expert' mode."""
    if _CTX is None:
        return buf
    entries = [None] * buf.ndim
    e_dim = buf.ndim - 3          # 1 for (G,E,C,D), 0 for (E,C,D)
    if e_dim == 1:
        entry = _batch_entry()
        if entry is not None and buf.shape[0] % _axis_size(entry) == 0:
            entries[0] = entry
    if moe_sharding == "expert" \
            and buf.shape[e_dim] % _axis_size(_CTX.model_axis) == 0:
        entries[e_dim] = _CTX.model_axis
    return _constrain(buf, entries)


def shard_group_tokens(x):
    """(G, Tg, D) grouped token block: groups over the batch axes."""
    if _CTX is None:
        return x
    entry = _batch_entry()
    if entry is None or x.shape[0] % _axis_size(entry) != 0:
        return x
    return _constrain(x, [entry] + [None] * (x.ndim - 1))


# ---------------------------------------------------------------------------
# per-rank bodies
# ---------------------------------------------------------------------------


def local_block(x, keep: Sequence[int] = ()):
    """``x``'s local tensor on this rank, and the placements it was taken
    at: every placement of the DTensor ``x`` that is not ``Shard(d)`` for
    a dim ``d`` in ``keep`` is gathered (a ``Partial`` summed) first."""
    from torch.distributed.tensor import Replicate
    want = [p if any(p.is_shard(d) for d in keep) else Replicate()
            for p in x.placements]
    if list(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    return x.to_local(), want


def resolve_partial(x):
    """A DTensor with its ``Partial`` placements summed (made
    ``Replicate``); anything else as it is."""
    from torch.distributed.tensor import Replicate
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def local_offset(shape, mesh, pl) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(local shape, global offset) of this rank's shard of a tensor of
    ``shape`` at placements ``pl`` on ``mesh``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local, offset = compute_local_shape_and_global_offset(
        torch.Size(shape), mesh, pl)
    return tuple(local), tuple(offset)


def from_block(local: torch.Tensor, mesh, pl, shape):
    """A body's local result as the DTensor of global ``shape`` at
    placements ``pl`` (its local tensor made contiguous, as the global
    stride it is given says)."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False,
                              shape=shape, stride=stride)


def model_share(x, n: int) -> Tuple[int, int]:
    """(W, index): how a per-rank body over DTensor ``x``'s mesh splits
    ``n`` heads (or channel blocks): over the W ranks of the model axis,
    this rank taking block ``index``, where W divides n; else (1, 0),
    every rank taking all n."""
    mesh = x.device_mesh
    name = _CTX.model_axis if _CTX is not None else "model"
    names = tuple(mesh.mesh_dim_names)
    if name not in names:
        return 1, 0
    m = names.index(name)
    w = mesh.mesh.shape[m]
    if w == 1 or n % w:
        return 1, 0
    return w, mesh.get_local_rank(m)


def body_placements(x, dim: Optional[int] = None, split: bool = True):
    """The placements of a per-rank body's tensors over DTensor ``x``'s
    mesh: ``x``'s batch shard (dim 0 sharded over a mesh dim) kept, the
    model axis over ``dim`` when ``split`` (else replicated), every other
    mesh dim replicated."""
    from torch.distributed.tensor import Replicate, Shard
    name = _CTX.model_axis if _CTX is not None else "model"
    out = []
    for axis, p in zip(x.device_mesh.mesh_dim_names, x.placements):
        if axis == name and split and dim is not None:
            out.append(Shard(dim))
        elif axis != name and p.is_shard(0):
            out.append(Shard(0))
        else:
            out.append(Replicate())
    return out


def body_input(t, pl, out_pl):
    """DTensor ``t``'s local tensor at placements ``pl``, for a per-rank
    body whose outputs sit at ``out_pl``. Its gradient is each rank's
    share where the ranks of a mesh dim do different work on a whole
    copy of ``t`` (``t`` replicated there while the outputs shard): a
    ``Partial`` sum, reduced into ``t``'s own layout on the way back."""
    from torch.distributed.tensor import Partial
    if list(t.placements) != list(pl):
        t = t.redistribute(t.device_mesh, pl)
    grad = [p if p.is_shard() else (Partial() if o.is_shard() else p)
            for p, o in zip(pl, out_pl)]
    return t.to_local(grad_placements=grad)


class _ModelSum(torch.autograd.Function):
    """The sum over an axis's ranks, and the same sum of the gradients on
    the way back (each rank's output feeds its own work)."""

    @staticmethod
    def forward(ctx, x, axis):
        from repro_torch.sharding import compat
        ctx.axis = axis
        return compat.psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.sharding import compat
        return compat.psum(g.contiguous(), ctx.axis), None


def body_sum(x, mesh):
    """A per-rank body's partial sums, summed over the model axis of
    ``mesh`` (``sharding.compat.psum``), differentiable."""
    from repro_torch.sharding import compat
    name = _CTX.model_axis if _CTX is not None else "model"
    return _ModelSum.apply(x, compat.mesh_axis(mesh, (name,)))


def write_into(dst, src, index=None, dim: int = 1):
    """``dst[index along dim] = src`` (``dst.copy_(src)`` when ``index`` is
    None), in place in each rank's shard when ``dst`` is a DTensor: the
    value is resharded to ``dst``'s layout and the rank whose shard holds
    ``index`` writes it. ``src`` lacks ``dim`` when ``index`` is given."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not is_dtensor(dst):
        if index is None:
            dst.copy_(src)
        else:
            dst.select(dim, index).copy_(src)
        return dst
    mesh = dst.device_mesh
    if not is_dtensor(src):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    if index is None:
        want = list(dst.placements)
    else:
        # dst's placements on src's dims: dims after `dim` shift down one
        want = [Replicate() if not p.is_shard() or p.dim == dim
                else Shard(p.dim - (p.dim > dim)) for p in dst.placements]
    if list(src.placements) != want:
        src = src.redistribute(mesh, want)
    mine = dst.to_local()
    value = src.to_local().to(mine.dtype)
    if index is None:
        mine.copy_(value)
        return dst
    local, offset = local_offset(dst.shape, mesh, dst.placements)
    if offset[dim] <= index < offset[dim] + local[dim]:
        mine.select(dim, index - offset[dim]).copy_(value)
    return dst
