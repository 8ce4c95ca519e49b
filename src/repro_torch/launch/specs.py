"""Input specs of the workload shapes, on ``meta`` tensors.

Counterpart of the mesh-free half of ``repro/launch/specs.py``: the
reference's ``ShapeDtypeStruct`` stand-ins become tensors on the ``meta``
device (shapes and dtypes, no storage), so a 405B-scale model's inputs
and half-terabyte decode caches are described without an allocation and
the model's own functions run on them (``launch/roofline.py``). The decode
cache keeps the port's layout (``transformer.cache_spec``: a list of
per-layer dicts, which ``decode_step`` takes);
``convert.lm_params_to_reference(cfg, {"blocks": cache})`` stacks it into
the reference's.

The mesh half: ``shardings_for`` resolves the logical axes of every
parameter into the reference's PartitionSpecs (in the reference's
stacked layout, so that they compare leaf by leaf; the 'layers' axis is
never sharded), :func:`param_specs` gives them in the port's layout, and
the step builders return ``(fn, args, placements)``, the reference's
``(fn, arg_sds, in_shardings)``: ``args`` are ``meta`` tensors in the
port's layout (``input_specs``), ``placements`` the PartitionSpec trees
of the args, which ``sharding.rules.distribute_params`` places on the
mesh (DTensor placements: ``rules.placements``). ``fn`` runs one step
on args so placed and raises on any that are not DTensors: no step runs
unsharded in place of a sharded one.

Two layouts differ from the reference's. A decode cache is a list of
per-layer entries with no layer axis, so :func:`cache_specs` gives each
layer's leaves the reference's stacked spec without its layer entry. Under the gossip optimizer the peers are the ranks of the ``data``
axis (one peer a rank, ``core/gossip_optimizer.py``'s peer mesh), so a
rank's parameters are its peer's, with no peer dim, DTensors on the mesh
of the other axes (tensor parallel inside a peer).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import convert
from repro_torch.config.base import GossipConfig, InputShape, ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import meta
from repro_torch.sharding.act import activation_sharding, is_dtensor
from repro_torch.sharding.rules import (PS, cache_pspecs, default_rules,
                                        map_leaves, mesh_sizes,
                                        params_pspecs)
from repro_torch.utils.tree import tree_leaves, tree_map
from repro_torch.models.vision import (frame_embedding_spec,
                                       patch_embedding_spec)

LONG_WINDOW = 8192          # SWA window for dense archs on long_500k


def resolve_variant(cfg: ModelConfig,
                    shape: InputShape) -> Tuple[ModelConfig, Dict]:
    """Adapt a config to a workload shape; returns (cfg, notes).

    * long_500k on full-attention archs -> sliding-window variant (the
      sub-quadratic requirement); natively windowed/SSM archs unchanged.
    * whisper: long_500k unsupported (documented skip); decode self-cache
      capped at max_target_positions.
    """
    notes: Dict = {}
    if shape.name == "long_500k":
        if cfg.family == "audio":
            raise ValueError("long_500k x whisper: documented skip (DESIGN.md)")
        a = cfg.attention
        if a is not None and a.sliding_window is None:
            has_global_attn = any(k in ("attn", "cross", "selfcross")
                                  for k in cfg.layer_pattern)
            if has_global_attn:
                cfg = cfg.replace(
                    attention=dataclasses.replace(a, sliding_window=LONG_WINDOW))
                notes["attn"] = f"swa{LONG_WINDOW}"
    if cfg.family == "audio" and shape.kind == "decode":
        notes["self_cache"] = (f"capped at {cfg.max_target_positions} target "
                               "positions")
    return cfg, notes


def needs_encoder_input(cfg: ModelConfig) -> bool:
    return cfg.family in ("vlm", "audio")


def encoder_input_spec(cfg: ModelConfig, batch: int) -> torch.Tensor:
    """The encoder-side input as a ``meta`` tensor: the patch embeddings
    (vlm) or the frames (audio), in the compute dtype (the reference's
    ``encoder_input_sds``)."""
    if cfg.family == "vlm":
        return patch_embedding_spec(cfg, batch)
    return frame_embedding_spec(cfg, batch)


def input_specs(cfg: ModelConfig, shape: InputShape, *,
                n_peers: int = 0) -> Dict:
    """``meta`` stand-ins for every model input of this workload: train
    ``tokens``/``labels`` (int32, (B, S), or (peers, B / peers, S) under
    gossip) and ``encoder_out``; prefill ``tokens`` and ``encoder_out``;
    decode ONE new ``token`` (B,), the ``cache`` of ``seq_len`` positions
    (``transformer.cache_spec``) and the 0-d ``index``."""
    gb, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        if n_peers:
            if gb % n_peers:
                raise ValueError(f"batch {gb} does not split over {n_peers} "
                                 "peers")
            tok = meta((n_peers, gb // n_peers, s), torch.int32)
        else:
            tok = meta((gb, s), torch.int32)
        out = {"tokens": tok, "labels": meta(tok.shape, torch.int32)}
        if needs_encoder_input(cfg):
            if n_peers:
                e = encoder_input_spec(cfg, gb // n_peers)
                out["encoder_out"] = meta((n_peers,) + tuple(e.shape),
                                          e.dtype)
            else:
                out["encoder_out"] = encoder_input_spec(cfg, gb)
        return out
    if shape.kind == "prefill":
        out = {"tokens": meta((gb, s), torch.int32)}
        if needs_encoder_input(cfg):
            out["encoder_out"] = encoder_input_spec(cfg, gb)
        return out
    return {"token": meta((gb,), torch.int32),
            "cache": T.cache_spec(cfg, gb, s),
            "index": meta((), torch.int32)}


# ---------------------------------------------------------------------------
# sharding resolution
# ---------------------------------------------------------------------------


def _is_spec(x) -> bool:
    return isinstance(x, PS)


def _batch_spec(mesh, ndim: int, *, peer: bool = False,
                peer_axes: Tuple[str, ...] = ()) -> PS:
    multi = "pod" in mesh_sizes(mesh)
    if peer:
        rest = tuple(a for a in (("pod", "data") if multi else ("data",))
                     if a not in peer_axes)
        second = rest[0] if rest else None
        return PS(peer_axes if len(peer_axes) > 1 else peer_axes[0], second,
                  *([None] * (ndim - 2)))
    bx = ("pod", "data") if multi else "data"
    return PS(bx, *([None] * (ndim - 1)))


def shardings_for(cfg: ModelConfig, mesh, *,
                  gossip: Optional[GossipConfig] = None,
                  peer_axes: Tuple[str, ...] = ("data",),
                  inference: bool = False):
    """(PartitionSpec tree in the reference's stacked layout, rules) for
    this config on this mesh; under ``gossip`` each spec has the peer axes
    in front (the reference's peer dim)."""
    multi = "pod" in mesh_sizes(mesh)
    moe_mode = cfg.moe.sharding if cfg.moe else "expert"
    if gossip is not None:
        rules = default_rules(multi_pod=multi, fsdp=True,
                              moe_sharding=moe_mode, peer_axes=peer_axes)
    else:
        rules = default_rules(multi_pod=multi, fsdp=True,
                              moe_sharding=moe_mode, inference=inference)
    axes = convert.lm_axes_to_reference(cfg, T.param_axes(cfg))
    shapes = convert.lm_params_to_reference(cfg, T.abstract_params(cfg))
    pspecs = params_pspecs(axes, shapes, mesh, rules)
    if gossip is not None:
        peer = peer_axes if len(peer_axes) > 1 else peer_axes[0]
        pspecs = map_leaves(lambda ps: PS(peer, *ps), pspecs,
                            is_leaf=_is_spec)
    return pspecs, rules


def _drop(ps: PS, i: int) -> PS:
    """``ps`` without its entry ``i`` (a stacked axis), trailing Nones
    dropped."""
    entries = list(ps[:i]) + list(ps[i + 1:])
    while entries and entries[-1] is None:
        entries.pop()
    return PS(*entries)


def param_specs(cfg: ModelConfig, pspecs, lead: int = 0):
    """``shardings_for``'s specs in the port's layout (a list of layers):
    each stacked leaf's spec without its layer entry (after ``lead``
    leading entries), which the rules never shard."""
    def unstack(ps, _):
        if len(ps) > lead and ps[lead] is not None:
            raise ValueError(f"a spec shards the layer axis: {ps}")
        return _drop(ps, lead)
    return convert.lm_tree_from_reference(cfg, pspecs, unstack)


def cache_specs(cfg: ModelConfig, cache, mesh, *,
                profile: str = "context"):
    """PartitionSpecs of a decode cache in the port's layout (a list of
    per-layer dicts): ``rules.cache_pspecs`` of the reference's stacked
    cache, each stacked leaf's spec without its layer entry. Where the
    reference shards the layer stack itself (a stack that the data or
    model axis divides), the port, which has no layer axis, leaves that
    mesh axis unused for the leaf."""
    multi = "pod" in mesh_sizes(mesh)
    stacked = cache_pspecs(convert.lm_params_to_reference(
        cfg, {"blocks": cache}), mesh, multi_pod=multi, profile=profile)
    period = len(cfg.layer_pattern)
    nb = cfg.num_layers // period
    out = []
    for i in range(cfg.num_layers):
        if i < nb * period:
            entry = stacked["blocks"][f"l{i % period}"]
            out.append({k: _drop(ps, 0) for k, ps in entry.items()})
        else:
            out.append(dict(stacked["tail"][f"t{i - nb * period}"]))
    return out


def _batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_sizes(mesh) else ("data",)


def _require_mesh(tree) -> None:
    """Raise unless every tensor of ``tree`` is a DTensor."""
    plain = [t for t in tree_leaves(tree)
             if isinstance(t, torch.Tensor) and not is_dtensor(t)]
    if plain:
        raise ValueError(f"{len(plain)} args are not DTensors: a step "
                         "builder's fn runs on args placed on its mesh "
                         "(sharding.rules.distribute_params)")


def _whole(t):
    """A replicated DTensor (the step counter) as its plain value: the
    schedules and the optimizer take it as a scalar."""
    return t.full_tensor() if is_dtensor(t) else t


# ---------------------------------------------------------------------------
# step builders (train / prefill / decode), all returning
# (fn, args: tuple of meta trees, placements: tuple of PartitionSpec trees)
# ---------------------------------------------------------------------------


def make_loss_fn(cfg: ModelConfig):
    def loss_fn(params, batch):
        return T.lm_loss(params, cfg, batch["tokens"], batch["labels"],
                         encoder_out=batch.get("encoder_out"))
    return loss_fn


def build_train_step(cfg: ModelConfig, shape: InputShape, mesh, *,
                     optimizer: str = "adamw",
                     gossip: Optional[GossipConfig] = None,
                     n_peers: int = 0, lr: float = 3e-4):
    """The train step on ``mesh``. All-reduce (``gossip`` None): the
    parameters and the optimizer state at the ``tp_fsdp`` specs, the
    batch over the batch axes; ``fn(params, opt_state, step, batch) ->
    (params, opt_state, step + 1, loss)``, the update in place.

    Gossip: the peers are the ``data`` ranks (``n_peers`` of them). A
    rank's args are its peer's parameters, state and batch (no peer dim),
    placed on ``peer_mesh(mesh)``, the mesh of the other axes, at the
    ``tp_only`` specs without the peer entry; the step is the peer mesh's
    ``make_gossip_train_step`` with the round-0 partner permutation (the
    reference lowers with it), the merge permuting each rank's rows over
    ``data`` (kernel #2 encoding a quantized exchange's rows)."""
    from repro_torch.core import gossip_optimizer as go
    from repro_torch.optim import make_optimizer, warmup_cosine
    sched = warmup_cosine(lr, 100, 10_000)
    opt = make_optimizer(optimizer, sched)
    loss_fn = make_loss_fn(cfg)
    peer_axes = ("data",)
    pspecs, _ = shardings_for(cfg, mesh, gossip=gossip, peer_axes=peer_axes)
    params = T.abstract_params(cfg)
    step_arg = meta((), torch.int32)

    if gossip is not None:
        if n_peers != mesh_sizes(mesh)["data"]:
            raise ValueError(f"{n_peers} peers on a data axis of "
                             f"{mesh_sizes(mesh)['data']} ranks")
        p_specs = param_specs(cfg, map_leaves(
            lambda ps: _drop(ps, 0), pspecs, is_leaf=_is_spec))
        opt_state = opt.init(params)
        batch = {k: meta(tuple(v.shape[1:]), v.dtype) for k, v in
                 input_specs(cfg, shape, n_peers=n_peers).items()}
        inner = peer_mesh(mesh, peer_axes)
        batch_specs = {k: _drop(_batch_spec(mesh, v.ndim + 1, peer=True,
                                            peer_axes=peer_axes), 0)
                       for k, v in batch.items()}
        g_step = go.make_gossip_train_step(loss_fn, opt, n_peers, gossip,
                                           mesh=mesh, peer_axes=peer_axes)
        perm0, _ = go.perms_for_step(gossip, 0, n_peers)

        def step(params, opt_state, step_idx, batch):
            _require_mesh((params, batch))
            step_idx = _whole(step_idx)
            with activation_sharding(inner, ()):
                st, loss, _ = g_step(go.GossipState(params, opt_state,
                                                    step_idx), batch, perm0)
            return st.params, st.opt_state, st.step, loss

        args = (params, opt_state, step_arg, batch)
        specs = (p_specs, {k: p_specs for k in opt_state}, PS(), batch_specs)
        return step, args, specs

    p_specs = param_specs(cfg, pspecs)
    opt_state = opt.init(params)
    batch = input_specs(cfg, shape)
    batch_specs = {k: _batch_spec(mesh, v.ndim) for k, v in batch.items()}
    a_step = go.make_allreduce_train_step(loss_fn, opt)
    batch_axes = _batch_axes(mesh)

    def step(params, opt_state, step_idx, batch):
        _require_mesh((params, batch))
        step_idx = _whole(step_idx)
        with activation_sharding(mesh, batch_axes):
            new_p, new_o, loss, _ = a_step(params, opt_state, batch,
                                           step_idx)
        return new_p, new_o, step_idx + 1, loss

    args = (params, opt_state, step_arg, batch)
    specs = (p_specs, {k: p_specs for k in opt_state}, PS(), batch_specs)
    return step, args, specs


def peer_mesh(mesh, peer_axes: Tuple[str, ...] = ("data",)):
    """The mesh of ``mesh``'s axes other than the peer axes: where a
    gossip peer's parameters live (tensor parallel over 'model')."""
    rest = tuple(a for a in mesh.mesh_dim_names if a not in peer_axes)
    return mesh[rest if len(rest) > 1 else rest[0]]


def build_prefill_step(cfg: ModelConfig, shape: InputShape, mesh, *,
                       cache_len: Optional[int] = None,
                       decode_profile: str = "context"):
    """The prefill on ``mesh``: the parameters at the ``tp_fsdp`` specs,
    the batch over the batch axes; ``fn(params, batch)`` returns the
    last position's logits (the reference's realistic prefill output).
    With ``cache_len`` (the port's serve path) ``fn`` runs the fused
    prefill instead and returns ``(logits, cache)``, the cache of
    ``cache_len`` slots at :func:`build_decode_step`'s specs for
    ``decode_profile``, ready for its decode step."""
    p_specs = param_specs(cfg, shardings_for(cfg, mesh)[0])
    batch = input_specs(cfg, shape)
    batch_specs = {k: _batch_spec(mesh, v.ndim) for k, v in batch.items()}
    batch_axes = _batch_axes(mesh)
    if cache_len is not None:
        c_specs = cache_specs(cfg, T.cache_spec(cfg, shape.global_batch,
                                                cache_len), mesh,
                              profile=decode_profile)

    def step(params, batch):
        _require_mesh((params, batch))
        with activation_sharding(mesh, batch_axes):
            if cache_len is None:
                logits, _ = T.forward(params, cfg, batch["tokens"],
                                      encoder_out=batch.get("encoder_out"),
                                      last_only=True)
                return logits
            logits, cache = T.prefill(params, cfg, batch["tokens"],
                                      cache_len,
                                      encoder_out=batch.get("encoder_out"))
        return logits, _place_cache(cache, c_specs, mesh)

    return step, (T.abstract_params(cfg), batch), (p_specs, batch_specs)


def _place_cache(cache, specs, mesh):
    """Each cache leaf resharded to its spec's placements."""
    from repro_torch.sharding.rules import placements
    return map_leaves(
        lambda t, ps: t.redistribute(mesh, placements(ps, mesh)), cache,
        specs, is_leaf=lambda x: isinstance(x, torch.Tensor))


def build_decode_step(cfg: ModelConfig, shape: InputShape, mesh, *,
                      profile: str = "context"):
    """The decode step on ``mesh``.

    profile='context' (default): the cache's length dim over 'data'
    (context-parallel decode), the token and the activations replicated
    over 'data', so the FSDP-sharded weights are used in place; serving
    weights in the compute dtype. 'batch': the cache's batch over the
    batch axes, the token too where it divides, float32 weights. 'tp2d':
    the weights at the ``tp2d_inference`` specs.

    ``fn(params, token, cache, index) -> (logits, cache)``, the cache
    written in place (``index`` a Python int or a 0-d tensor)."""
    multi = "pod" in mesh_sizes(mesh)
    params = T.abstract_params(cfg)
    if profile == "context":
        params = tree_map(lambda t: meta(
            t.shape, cfg.compute_dtype if t.dtype == torch.float32
            else t.dtype), params)
    p_specs = param_specs(cfg, shardings_for(
        cfg, mesh, inference=(profile == "tp2d"))[0])
    specs = input_specs(cfg, shape)
    c_specs = cache_specs(cfg, specs["cache"], mesh, profile=profile)
    bx = _batch_axes(mesh)
    bsz = math.prod(mesh_sizes(mesh)[a] for a in bx)
    gb = specs["token"].shape[0]
    if profile == "context" or gb % bsz:
        tok_spec, dec_batch_axes = PS(), ()
    else:
        tok_spec, dec_batch_axes = PS(bx if multi else "data"), bx

    def step(params, token, cache, index):
        _require_mesh((params, token, cache))
        with activation_sharding(mesh, dec_batch_axes):
            return T.decode_step(params, cfg, token, cache, int(index))

    args = (params, specs["token"], specs["cache"], specs["index"])
    return step, args, (p_specs, tok_spec, c_specs, PS())


def _with_dispatch_groups(cfg: ModelConfig, shape: InputShape,
                          mesh) -> ModelConfig:
    """Set the MoE grouped-dispatch count to the batch-shard size, so each
    data shard owns its (E, C_group, D) buffer (``models/moe.py``), and
    the reduce combine under 'tensor' sharding."""
    if cfg.moe is None or cfg.moe.dispatch_groups != 1:
        return cfg
    sizes = mesh_sizes(mesh)
    bsz = math.prod(sizes[a] for a in _batch_axes(mesh))
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind in ("train", "prefill")
                                   else 1)
    combine = "reduce" if cfg.moe.sharding == "tensor" else cfg.moe.combine
    if bsz > 1 and shape.global_batch % bsz == 0 and tokens % bsz == 0:
        return cfg.replace(moe=dataclasses.replace(
            cfg.moe, dispatch_groups=bsz, combine=combine))
    return cfg


def build_step(cfg: ModelConfig, shape: InputShape, mesh, *,
               dist: str = "allreduce", n_peers: int = 0,
               optimizer: str = "adamw", decode_profile: str = "context"):
    """Dispatch on the workload kind; returns (fn, args, placements,
    notes)."""
    cfg, notes = resolve_variant(cfg, shape)
    cfg = _with_dispatch_groups(cfg, shape, mesh)
    if cfg.moe is not None and cfg.moe.dispatch_groups > 1:
        notes["moe"] = f"grouped-dispatch G={cfg.moe.dispatch_groups}"
    if shape.kind == "train":
        gossip = GossipConfig() if dist == "gossip" else None
        if dist == "gossip" and n_peers == 0:
            n_peers = mesh_sizes(mesh)["data"]
        fn, args, specs = build_train_step(cfg, shape, mesh,
                                           optimizer=optimizer,
                                           gossip=gossip, n_peers=n_peers)
    elif shape.kind == "prefill":
        fn, args, specs = build_prefill_step(cfg, shape, mesh)
    else:
        fn, args, specs = build_decode_step(cfg, shape, mesh,
                                            profile=decode_profile)
        notes["decode"] = decode_profile
    return fn, args, specs, notes
