"""State carried across between the JAX package and the port.

The reference's sharded chunk function carries a 14-tuple
(``repro/core/sharded_engine.py``, the carry built in
``run_sharded_simulation``): ``last_w, last_t, fresh_w, fresh_t, cache.w,
cache.t, cache.ptr, cache.count, buf_w, buf_t, buf_scale, buf_zp, ef,
clock``. ``buf_w`` holds the wire codec's payload (f32, bf16, f16, int8 or
packed uint8), ``buf_scale``/``buf_zp`` are f16 and ``ef`` f32; a lane the
codec does not carry is an empty (0, 0) array. These helpers move that
carry, as numpy arrays, into the port's
:class:`~repro_torch.core.sharded_engine.Carry` and back, each lane in its
own dtype, and rebuild a config from ``dataclasses.asdict`` of the
reference's. ``snapshot_from_arrays`` does the same for the reference's
serving ``QuerySnapshot``, and ``linear_model_from_arrays`` for a
``LinearModel`` (one model or a population, as the ensemble baselines
carry it). numpy has no bfloat16 of its own: a bf16 ``buf_w`` comes in
as the reference's array and goes back out as its raw bits (uint16).

For the LM stack, ``model_config_from_dict`` rebuilds a ``ModelConfig`` from
``dataclasses.asdict`` of the reference's, and ``lm_params_from_arrays``
moves the reference's parameter pytree (as numpy arrays) into the port's
``Params``: the reference stacks the layers of each pattern position
(``blocks/l{j}`` with a leading layer axis, remainder layers under
``tail/t{j}``), the port keeps one entry per layer in order; the
encoder's layers (``encoder/blocks``, stacked on the encoder's own layer
axis) likewise; each leaf keeps its dtype (a bf16 model's float32
``router``, ``A_log``, ``D``, ``dt_bias``, ``lam`` and the cross layers'
0-d ``gate_attn``/``gate_ffn`` stay float32). ``lm_params_to_arrays`` is the
inverse (``lm_params_to_reference`` the same layout as tensors, which the
trainer's checkpoints write). ``lm_cache_from_arrays`` moves the
reference's decode cache (stacked the same way; a cross layer's ``ck`` and
``cv`` too) into the port's list of per-layer dicts, and
``gossip_state_from_arrays`` moves a gossip optimizer's state (the
peer-stacked parameters, the optimizer's state and the step) across.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.config import base as cfg_base
from repro_torch.configs.gossip_linear import GossipLinearConfig
from repro_torch.core.cache import ModelCache
from repro_torch.core.learners import LinearModel
from repro_torch.core.serving import STATE_FIELDS, QuerySnapshot
from repro_torch.core.sharded_engine import Carry

CARRY_FIELDS = ("last_w", "last_t", "fresh_w", "fresh_t", "cache_w",
                "cache_t", "ptr", "count", "buf_w", "buf_t", "buf_scale",
                "buf_zp", "ef", "clock")
_DTYPES = {"last_w": torch.float32, "fresh_w": torch.float32,
           "cache_w": torch.float32, "buf_scale": torch.float16,
           "buf_zp": torch.float16, "ef": torch.float32}
_PAYLOAD = {np.dtype(np.float32): torch.float32,
            np.dtype(np.float16): torch.float16,
            np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8}


def _bf16_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A bfloat16 array (the reference's ``ml_dtypes`` type), moved by its
    bits."""
    bits = np.ascontiguousarray(a).view(np.int16)
    return torch.tensor(bits, device=device).view(torch.bfloat16)


def _payload_tensor(a: np.ndarray, device) -> torch.Tensor:
    """``buf_w`` in its own dtype; a bfloat16 array (the reference's
    ``ml_dtypes`` type) is moved by its bits."""
    if a.dtype.name == "bfloat16":
        return _bf16_tensor(a, device)
    try:
        dtype = _PAYLOAD[a.dtype]
    except KeyError:
        raise ValueError(f"buf_w of dtype {a.dtype} is no wire codec's "
                         "payload") from None
    return torch.tensor(a, dtype=dtype, device=device)


def state_from_arrays(arrays: Sequence, device) -> Carry:
    """The reference chunk carry (14 arrays in ``CARRY_FIELDS`` order) as
    the port's tensors on ``device``."""
    if len(arrays) != len(CARRY_FIELDS):
        raise ValueError(f"expected {len(CARRY_FIELDS)} carry arrays "
                         f"({', '.join(CARRY_FIELDS)}), got {len(arrays)}")
    a = {k: np.asarray(v) for k, v in zip(CARRY_FIELDS, arrays)}
    t = {k: torch.tensor(a[k], dtype=_DTYPES.get(k, torch.int32),
                         device=device)
         for k in CARRY_FIELDS[:13] if k != "buf_w"}
    return Carry(t["last_w"], t["last_t"], t["fresh_w"], t["fresh_t"],
                 ModelCache(t["cache_w"], t["cache_t"], t["ptr"],
                            t["count"]),
                 _payload_tensor(a["buf_w"], device), t["buf_t"],
                 t["buf_scale"], t["buf_zp"], t["ef"], int(a["clock"]))


def _np(x: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bfloat16 as its uint16 bits."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def to_arrays(carry: Carry) -> tuple:
    """The port's carry as the reference's 14-tuple of numpy arrays (a
    bf16 ``buf_w`` as its uint16 bits)."""
    return (_np(carry.last_w), _np(carry.last_t), _np(carry.fresh_w),
            _np(carry.fresh_t), _np(carry.cache.w), _np(carry.cache.t),
            _np(carry.cache.ptr), _np(carry.cache.count), _np(carry.buf_w),
            _np(carry.buf_t), _np(carry.buf_scale), _np(carry.buf_zp),
            _np(carry.ef), np.asarray(carry.clock, np.int32))


def snapshot_from_arrays(arrays: Sequence, device) -> QuerySnapshot:
    """The reference's ``QuerySnapshot`` (its six fields as numpy arrays,
    in ``serving.STATE_FIELDS`` order) as the port's, on ``device``."""
    if len(arrays) != len(STATE_FIELDS):
        raise ValueError(f"expected {len(STATE_FIELDS)} snapshot "
                         f"arrays ({', '.join(STATE_FIELDS)}), got "
                         f"{len(arrays)}")
    w, t, count, fresh_w, fresh_t, clock = (np.asarray(a) for a in arrays)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=device)
    return QuerySnapshot(f32(w), i32(t), i32(count), f32(fresh_w),
                         i32(fresh_t), int(clock))


def linear_model_from_arrays(w, t, device) -> LinearModel:
    """The reference's ``LinearModel(w, t)`` (as numpy arrays: w (d,) or
    (N, d), t () or (N,)) as the port's, w float32 and t int32 on
    ``device``."""
    w, t = np.asarray(w), np.asarray(t)
    if w.ndim not in (1, 2) or t.shape != w.shape[:-1]:
        raise ValueError(f"expected w (d,) or (N, d) with t () or (N,), got "
                         f"w {w.shape} and t {t.shape}")
    return LinearModel(torch.tensor(w, dtype=torch.float32, device=device),
                       torch.tensor(t, dtype=torch.int32, device=device))


def config_from_dict(d: Mapping) -> GossipLinearConfig:
    """The port's config from ``dataclasses.asdict`` of the reference's."""
    known = {f.name for f in dataclasses.fields(GossipLinearConfig)}
    bad = sorted(set(d) - known)
    if bad:
        raise ValueError(f"unknown GossipLinearConfig field(s) {bad}")
    kw = dict(d)
    if "class_ratio" in kw:
        kw["class_ratio"] = tuple(kw["class_ratio"])
    return GossipLinearConfig(**kw)


# ---------------------------------------------------------------------------
# the LM stack
# ---------------------------------------------------------------------------

_SUB_CONFIGS = {"attention": cfg_base.AttentionConfig,
                "moe": cfg_base.MoEConfig, "ssm": cfg_base.SSMConfig,
                "rglru": cfg_base.RGLRUConfig,
                "encoder": cfg_base.EncoderConfig,
                "cross_attn": cfg_base.CrossAttnConfig}
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def _torch_dtype(dt) -> torch.dtype:
    """A reference dtype (``jnp.float32``, ``jnp.bfloat16``, ...) by name."""
    name = np.dtype(dt).name
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"no torch dtype for {name}") from None


def model_config_from_dict(d: Mapping) -> cfg_base.ModelConfig:
    """The port's ``ModelConfig`` from ``dataclasses.asdict`` of the
    reference's: sub-configs rebuilt, dtypes mapped by name, and the
    reference's ``attn_impl="pallas"`` (its flash kernel) as ``"flash"``."""
    known = {f.name for f in dataclasses.fields(cfg_base.ModelConfig)}
    bad = sorted(set(d) - known)
    if bad:
        raise ValueError(f"unknown ModelConfig field(s) {bad}")
    kw = dict(d)
    for name, cls in _SUB_CONFIGS.items():
        if kw.get(name) is not None:
            kw[name] = cls(**kw[name])
    kw["layer_pattern"] = tuple(kw["layer_pattern"])
    for name in ("param_dtype", "compute_dtype"):
        if name in kw:
            kw[name] = _torch_dtype(kw[name])
    if kw.get("attn_impl") == "pallas":
        kw["attn_impl"] = "flash"
    return cfg_base.ModelConfig(**kw)


def _reference_leaf(tree: Mapping, cfg: cfg_base.ModelConfig, path,
                    lead: int = 0):
    """The reference's array for the port's parameter ``path``; layer i is
    entry i // period of ``blocks/l{i % period}`` (its layer axis after
    ``lead`` leading axes, such as the gossip optimizer's peer axis), or a
    ``tail`` layer; encoder layer i is entry i of ``encoder/blocks``."""
    if path[:2] == ("encoder", "blocks"):
        node = tree["encoder"]["blocks"]
        for name in path[3:]:
            node = node[name]
        return np.asarray(node)[(slice(None),) * lead + (path[2],)]
    if path[0] != "blocks":
        node = tree
        for name in path:
            node = node[name]
        return np.asarray(node)
    i, rest = path[1], path[2:]
    period = len(cfg.layer_pattern)
    nb = cfg.num_layers // period
    if i < nb * period:
        node = tree["blocks"][f"l{i % period}"]
    else:
        node = tree["tail"][f"t{i - nb * period}"]
    for name in rest:
        node = node[name]
    node = np.asarray(node)
    if i >= nb * period:
        return node
    return node[(slice(None),) * lead + (i // period,)]


def _tensor(a, device) -> torch.Tensor:
    """An array as a tensor on ``device``; a bfloat16 array (the
    reference's ``ml_dtypes`` type) moved by its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return _bf16_tensor(a, device)
    return torch.tensor(a, device=device)


def lm_params_from_arrays(cfg: cfg_base.ModelConfig, tree: Mapping, device):
    """The reference's parameter pytree (nested dicts of arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's ``Params`` on
    ``device``; a bf16 leaf is moved by its bits. Every leaf must have the
    port spec's shape and dtype."""
    from repro_torch.models.layers import build_params
    from repro_torch.models.transformer import model_spec

    return build_params(model_spec(cfg), lambda path, p: _tensor(
        _reference_leaf(tree, cfg, path), device))


def lm_cache_from_arrays(cfg: cfg_base.ModelConfig, tree: Mapping, device):
    """The reference's decode cache (``init_cache``/``prefill``'s pytree as
    numpy arrays: ``blocks/l{j}`` stacked on a leading layer axis,
    ``tail/t{j}``) as the port's list of per-layer dicts on ``device``
    (``{"k", "v"}``, ``{"ssm", "conv"}``, ``{"h", "conv"}``, a cross
    layer's ``{"ck", "cv"}`` or all four of a selfcross layer, each entry
    in its own dtype; bf16 moved by its bits)."""
    period = len(cfg.layer_pattern)
    nb = cfg.num_layers // period
    out = []
    for i in range(cfg.num_layers):
        node = (tree["blocks"][f"l{i % period}"] if i < nb * period
                else tree["tail"][f"t{i - nb * period}"])
        out.append({name: _tensor(_reference_leaf(tree, cfg,
                                                  ("blocks", i, name)),
                                  device)
                    for name in node})
    return out


def lm_params_to_reference(cfg: cfg_base.ModelConfig, params, lead: int = 0):
    """The port's parameters (a ``Params`` or a tree in its layout, each
    leaf with ``lead`` leading axes, such as the gossip optimizer's peer
    axis; or ``{"blocks": cache}``, a decode cache) in the reference's
    layout, as detached tensors on their device (``meta`` ones too):
    the layers of pattern position j stacked into ``blocks/l{j}`` on a
    layer axis after the leading ones, the remainder layers under
    ``tail/t{j}``, the encoder's layers stacked into ``encoder/blocks``."""
    from repro_torch.utils.tree import tree_map

    tree = tree_map(lambda x: x.detach(), params)
    layers = tree["blocks"]
    period = len(cfg.layer_pattern)
    nb = cfg.num_layers // period
    out = {k: v for k, v in tree.items() if k != "blocks"}
    if "encoder" in tree:
        out["encoder"] = dict(tree["encoder"], blocks=tree_map(
            lambda *xs: torch.stack(xs, dim=lead),
            *tree["encoder"]["blocks"]))
    if nb > 0:
        out["blocks"] = {
            f"l{j}": tree_map(lambda *xs: torch.stack(xs, dim=lead),
                              *layers[j:nb * period:period])
            for j in range(period)}
    if nb * period < cfg.num_layers:
        out["tail"] = {f"t{j}": layer for j, layer
                       in enumerate(layers[nb * period:])}
    return out


def lm_params_to_arrays(cfg: cfg_base.ModelConfig, params, lead: int = 0):
    """The inverse of :func:`lm_params_from_arrays`: the reference's
    parameter pytree (``lm_params_to_reference``'s layout) as numpy arrays,
    a bfloat16 leaf as its uint16 bits (numpy has no bfloat16)."""
    from repro_torch.utils.tree import tree_map
    return tree_map(_np, lm_params_to_reference(cfg, params, lead))


def _lm_tree(cfg: cfg_base.ModelConfig, tree: Mapping, device, lead: int):
    """The reference's parameter-layout tree with ``lead`` leading axes in
    the port's layout (nested dicts, ``blocks`` a list of layers)."""
    from repro_torch.models.layers import P
    from repro_torch.models.transformer import model_spec

    def build(spec, prefix):
        if isinstance(spec, list):
            return [build(s, prefix + (i,)) for i, s in enumerate(spec)]
        return {name: (_tensor(_reference_leaf(tree, cfg, prefix + (name,),
                                               lead), device)
                       if isinstance(s, P) else build(s, prefix + (name,)))
                for name, s in spec.items()}
    return build(model_spec(cfg), ())


def lm_axes_to_reference(cfg: cfg_base.ModelConfig, axes):
    """The port's logical-axes tree (``transformer.param_axes``) in the
    reference's layout (``lm_params_to_reference``'s): the layers of
    pattern position j under ``blocks/l{j}``, each leaf with the 'layers'
    axis in front (``layers.stack_spec``), the remainder layers under
    ``tail/t{j}``, the encoder's layers stacked into ``encoder/blocks``."""
    from repro_torch.sharding.rules import map_leaves

    def stack(*xs):
        if any(x != xs[0] for x in xs):
            raise ValueError(f"stacked layers differ in axes: {xs}")
        return ("layers",) + tuple(xs[0])

    def stacked(layers):
        return map_leaves(stack, layers[0], *layers[1:])

    out = {k: v for k, v in axes.items() if k != "blocks"}
    if "encoder" in axes:
        out["encoder"] = dict(axes["encoder"],
                              blocks=stacked(axes["encoder"]["blocks"]))
    layers = axes["blocks"]
    period = len(cfg.layer_pattern)
    nb = cfg.num_layers // period
    if nb > 0:
        out["blocks"] = {f"l{j}": stacked(layers[j:nb * period:period])
                         for j in range(period)}
    if nb * period < cfg.num_layers:
        out["tail"] = {f"t{j}": layer for j, layer
                       in enumerate(layers[nb * period:])}
    return out


def lm_tree_from_reference(cfg: cfg_base.ModelConfig, tree: Mapping,
                           unstack):
    """A tree in the reference's parameter layout, of any leaves (arrays,
    partition specs), in the port's: layer i's leaf is ``unstack(leaf,
    i // period)`` of ``blocks/l{i % period}`` (or ``unstack(leaf, i)`` of
    ``encoder/blocks``), a ``tail`` layer's its own."""
    from repro_torch.models.layers import P
    from repro_torch.models.transformer import model_spec
    period = len(cfg.layer_pattern)
    nb = cfg.num_layers // period

    def leaf(path):
        index = None
        if path[:2] == ("encoder", "blocks"):
            path, index = ("encoder", "blocks") + path[3:], path[2]
        elif path[0] == "blocks":
            i, rest = path[1], path[2:]
            if i < nb * period:
                path, index = ("blocks", f"l{i % period}") + rest, i // period
            else:
                path = ("tail", f"t{i - nb * period}") + rest
        node = tree
        for name in path:
            node = node[name]
        return node if index is None else unstack(node, index)

    def build(spec, prefix):
        if isinstance(spec, list):
            return [build(s, prefix + (i,)) for i, s in enumerate(spec)]
        return {name: leaf(prefix + (name,)) if isinstance(s, P)
                else build(s, prefix + (name,)) for name, s in spec.items()}
    return build(model_spec(cfg), ())


def gossip_state_from_arrays(params, opt_state, step, device,
                             cfg: cfg_base.ModelConfig = None):
    """The reference's ``GossipState`` (its peer-stacked params, its
    optimizer state — ``{}``, ``{"m"}`` or ``{"m", "v"}``, each a tree like
    the params — and its step, as numpy arrays or the reference's arrays)
    as the port's on ``device``. With ``cfg`` the trees are an LM's
    parameters, moved from the reference's stacked-layer layout into the
    port's; without, each leaf moves as it is."""
    from repro_torch.core.gossip_optimizer import GossipState
    from repro_torch.utils.tree import tree_map

    def move(tree):
        if cfg is not None:
            return _lm_tree(cfg, tree, device, lead=1)
        return tree_map(lambda a: _tensor(a, device), tree)
    return GossipState(move(params),
                       {k: move(v) for k, v in opt_state.items()},
                       torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                    device=device))
