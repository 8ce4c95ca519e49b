"""Logical axes -> partition specs -> DTensor placements.

Counterpart of ``repro/sharding/rules.py``. Every parameter leaf carries
logical axis names (``models/layers.py``). A :class:`LogicalRules`
profile maps each logical name to an ordered list of candidate mesh axes;
the first candidate that (a) divides the dimension and (b) is not already
used by another dim of the same tensor wins, otherwise the dim is
replicated (llama4's 40 heads on a 16-way model axis fall back to
replication while d_ff still shards).

Profiles (:func:`default_rules`): ``tp_fsdp`` (Megatron TP over 'model' +
ZeRO-3 FSDP over 'data', or ('pod', 'data') on two pods), ``tp_only``
(the gossip optimizer's: the peer axes never shard a parameter dim) and
``tp2d_inference`` (the decode profile: big dims over ('model', 'data')).

A :class:`PartitionSpec` is the reference's: one entry a tensor dim, each
None, a mesh axis name or a tuple of them, trailing Nones dropped. The
mesh is a ``torch.distributed`` ``DeviceMesh`` (``mesh_dim_names`` the
reference's axis names), or anything with ``axis_names`` and
``devices.shape``, or a dict of axis sizes: the rules read only the
sizes. :func:`placements` turns a spec into DTensor placements on a
``DeviceMesh``: a tensor dim named by mesh dim m is ``Shard(dim)`` on m,
every other mesh dim is ``Replicate()``. A dim over a tuple of axes is
``Shard`` on each of them; DTensor splits a dim over several mesh dims in
the mesh's order, so under ('model', 'data') on a ('data', 'model') mesh
a rank holds a shard of the reference's shape but maybe another one of
them than the reference's device of the same coordinates.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

# leaves smaller than this are always replicated (norm scales, gates, ...)
MIN_SHARD_ELEMS = 1 << 16


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: a tuple of per-dim entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


PS = PartitionSpec


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, of a reference-style
    mesh (``axis_names``, ``devices.shape``) or of a dict of sizes."""
    if isinstance(mesh, dict):
        return dict(mesh)
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


@dataclass(frozen=True)
class LogicalRules:
    name: str
    # logical axis -> candidate mesh axes, in priority order. A candidate may
    # itself be a tuple of mesh axes (sharded over their product).
    table: Dict[str, Tuple] = field(default_factory=dict)

    def candidates(self, logical: Optional[str]):
        if logical is None:
            return ()
        return self.table.get(logical, ())


def _fsdp_axes(multi_pod: bool):
    return (("pod", "data"), ("data",)) if multi_pod else (("data",),)


def default_rules(*, multi_pod: bool = False, fsdp: bool = True,
                  moe_sharding: str = "expert",
                  peer_axes: Tuple[str, ...] = (),
                  inference: bool = False) -> LogicalRules:
    """The standard rule table for a (pod?, data, model) mesh.

    ``inference=True`` (the decode profile): weights are stationary, the
    big dims 2D-sharded over ('model', 'data') (falling back to 'model'),
    and the FSDP 'embed' sharding is dropped, so no weight is re-gathered
    per decoded token."""
    if inference:
        two_d = (("model", "data"), ("model",))
        t = {
            "vocab": (("model",),),
            "embed": (),
            "embed_table": (),
            "ffn": two_d,
            "heads": two_d,
            "kv_heads": (("model",),),
            "head_dim": (("data",),),
            "expert": (("model",),) if moe_sharding == "expert" else (),
            # 'expert' mode: E on model, d_ff_expert on data (2D);
            # 'tensor' mode: d_ff_expert on (model, data)
            "expert_ffn": two_d if moe_sharding == "tensor" else (("data",),),
            "expert_router": (),
            "layers": (),
            "conv": (),
            "state": (),
            "peers": (),
            "batch": (),
            "seq": (),
        }
        return LogicalRules("tp2d_inference", t)
    fsdp_c = _fsdp_axes(multi_pod) if fsdp else ()
    # when gossiping, the peer axes must never shard parameter dims
    fsdp_c = tuple(c for c in fsdp_c
                   if not any(a in peer_axes
                              for a in (c if isinstance(c, tuple) else (c,))))
    t = {
        "vocab": (("model",),) + fsdp_c,
        "embed": fsdp_c,
        "embed_table": (),          # see models/layers.embedding_spec
        "ffn": (("model",),),
        "heads": (("model",),),
        "kv_heads": (("model",),),
        "head_dim": (),
        "expert": (("model",),) if moe_sharding == "expert" else (),
        "expert_ffn": (("model",),) if moe_sharding == "tensor" else fsdp_c,
        "expert_router": (),
        "layers": (),
        "conv": (),
        "state": (),
        "peers": (tuple(peer_axes),) if peer_axes else (),
        # activations / inputs
        "batch": ((("pod", "data") if multi_pod else ("data",)),),
        "seq": (),
    }
    return LogicalRules("tp_fsdp" if fsdp else "tp_only", t)


def partition_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
                   sizes: Dict[str, int], rules: LogicalRules) -> PS:
    """Resolve one tensor's logical axes into a PartitionSpec."""
    if math.prod(shape) < MIN_SHARD_ELEMS and "peers" not in axes:
        return PS()
    used: set = set()
    out = []
    for dim, logical in zip(shape, axes):
        chosen = None
        for cand in rules.candidates(logical):
            cand_t = cand if isinstance(cand, tuple) else (cand,)
            size = math.prod(sizes[a] for a in cand_t)
            if dim % size == 0 and size > 1 and not (used & set(cand_t)):
                chosen = cand_t if len(cand_t) > 1 else cand_t[0]
                used.update(cand_t)
                break
        out.append(chosen)
    while out and out[-1] is None:
        out.pop()
    return PS(*out)


def is_axes(x) -> bool:
    """A leaf of a logical-axes tree: a tuple of names and Nones."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def map_leaves(fn, tree, *rest, is_leaf=is_axes):
    """``fn`` over the leaves of trees of one structure (dicts and lists;
    ``is_leaf`` says what else is a leaf: tuples of axis names by
    default)."""
    if is_leaf(tree) or not isinstance(tree, (dict, list)):
        return fn(tree, *rest)
    if isinstance(tree, list):
        return [map_leaves(fn, t, *(r[i] for r in rest), is_leaf=is_leaf)
                for i, t in enumerate(tree)]
    return {k: map_leaves(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
            for k, v in tree.items()}


def params_pspecs(axes_tree, shapes_tree, mesh, rules: LogicalRules):
    """PartitionSpec tree for a params tree (tensors, ``meta`` ones too,
    or anything with ``.shape``) given its logical-axes tree."""
    sizes = mesh_sizes(mesh)
    return map_leaves(lambda ax, t: partition_spec(tuple(t.shape), ax,
                                                   sizes, rules),
                      axes_tree, shapes_tree)


def cache_pspecs(cache, mesh, *, multi_pod: bool = False,
                 profile: str = "context"):
    """Heuristic PartitionSpecs for decode caches / recurrent states, a
    pure function of each leaf's shape.

    profile='context' (default): shard the KV *length* dim (the longest
    dim) over 'data' (context-parallel decode), then a heads-like dim over
    'model'; batch stays unsharded. Falls back to batch-sharding when the
    length dim does not divide (whisper's 1500-frame cross cache).

    profile='batch' (the reference's v0 baseline): shard the batch dim
    over ('pod', 'data') when divisible, else the longest dim; plus a
    heads-like dim over 'model'.

    The reference applies it to its stacked cache, whose first dim is the
    layer stack; the port's decode cache is a list of per-layer entries,
    and ``launch/specs.py`` applies it to those (see ``cache_placements``
    there)."""
    sizes = mesh_sizes(mesh)
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    bsz = math.prod(sizes[a] for a in batch_axes)

    def batch_dim(shape):
        for bdim in (0, 1):
            if shape[bdim] % bsz == 0 and shape[bdim] >= bsz:
                return bdim
        return None

    def length_dim(shape):
        ldim = max(range(len(shape)), key=lambda i: (shape[i], -i))
        if shape[ldim] % bsz == 0 and shape[ldim] >= 4 * bsz:
            return ldim
        return None

    def one(t):
        shape = tuple(t.shape)
        spec = [None] * len(shape)
        if len(shape) >= 3:
            order = (length_dim, batch_dim) if profile == "context" \
                else (batch_dim, length_dim)
            for f in order:
                d = f(shape)
                if d is not None:
                    spec[d] = batch_axes if multi_pod else "data"
                    break
            # then the first eligible dim over 'model': for a KV leaf the
            # batch dim (batch over model x length over data); sharding
            # head_dim instead psums the whole logits (the reference's
            # measured note)
            for hdim in range(len(shape)):
                if spec[hdim] is None and shape[hdim] % sizes["model"] == 0 \
                        and sizes["model"] <= shape[hdim] <= 1024:
                    spec[hdim] = "model"
                    break
        elif len(shape) == 2:
            if shape[-1] % sizes["model"] == 0 and shape[-1] >= sizes["model"]:
                spec[-1] = "model"
        while spec and spec[-1] is None:
            spec.pop()
        return PS(*spec)

    return map_leaves(one, cache, is_leaf=lambda x: hasattr(x, "shape"))


def placements(spec: PS, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``):
    ``Shard(i)`` on each mesh dim that entry i names, ``Replicate()`` on
    the others."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.mesh_dim_names]
    for i, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                out[mesh.mesh_dim_names.index(a)] = Shard(i)
    return out


def named_sharding_tree(pspec_tree, mesh):
    """The tree of DTensor placements of a PartitionSpec tree on
    ``mesh`` (the reference's tree of ``NamedSharding``)."""
    return map_leaves(lambda ps: placements(ps, mesh), pspec_tree,
                      is_leaf=lambda x: isinstance(x, PS))


def _zip_placed(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of tensors (a ``Params``, dicts and
    lists) and a tree of PartitionSpecs of its nesting."""
    from repro_torch.utils.tree import _children
    kids = _children(tree)
    if kids is None:
        return fn(tree, specs)
    kind, keys, values = kids
    out = [_zip_placed(fn, v, specs[k]) for k, v in zip(keys, values)]
    return dict(zip(keys, out)) if kind is dict else kind(out)


def distribute_params(tree, mesh, pspecs):
    """A tree of tensors (a ``Params``, dicts and lists; parameters, an
    optimizer state, a batch or a cache) as DTensors on ``mesh`` at the
    placements of ``pspecs`` (a PartitionSpec tree of the same nesting),
    returned as dicts and lists. A full tensor (every rank drew the same
    one, from the same seed) keeps this rank's shard, with no
    communication; a ``meta`` tensor becomes a ``meta`` local shard of
    the spec's shard shape (the dry run at production size). A tensor on
    another device type than the mesh's raises."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding.act import from_block, local_offset

    def one(t, spec):
        t = t.detach()
        pl = placements(spec, mesh)
        if t.is_meta:
            local, _ = local_offset(t.shape, mesh, pl)
            return from_block(torch.empty(local, dtype=t.dtype,
                                          device="meta"), mesh, pl, t.shape)
        if t.device.type != mesh.device_type:
            raise ValueError(f"a {t.device.type} tensor on a "
                             f"{mesh.device_type} mesh")
        return distribute_tensor(t, mesh, pl, src_data_rank=None)
    return _zip_placed(one, tree, pspecs)
