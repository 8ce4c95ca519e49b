"""The LM's sharding rules against the JAX package, in process, no ranks.

- every architecture's logical-axes tree (``transformer.param_axes``,
  stacked by ``convert.lm_axes_to_reference``) equals the reference's
  ``param_axes`` leaf by leaf, at full width (spec trees cost nothing);
- ``shardings_for`` (all-reduce, gossip, ``inference=True``) and
  ``cache_pspecs`` (the ``context`` and ``batch`` profiles, on every
  decode shape's cache) equal the reference's PartitionSpecs leaf by leaf
  on the 16 x 16 and 2 x 16 x 16 meshes. The reference runs on a
  stand-in mesh (``axis_names`` and ``devices`` of the production shape):
  its rules read only the sizes;
- the port's per-layer cache specs (``specs.cache_specs``) equal the
  reference's without its layer entry wherever the reference leaves that
  entry unsharded, and the test lists the leaves where it shards it;
- every case of ``tests/test_sharding.py`` and the rule cases of
  ``tests/test_perf_profiles.py``, as parametrised cases on both rule
  sets;
- on ``make_production_mesh``'s fake 256- and 512-rank groups, every
  architecture's ``meta`` parameters placed by ``distribute_params`` at
  the port's specs: each leaf's local shape is the shard shape that the
  reference's PartitionSpec gives at those sizes.

All exact: names, specs and shapes.
"""
import math

import numpy as np
import pytest
import torch

from repro.config import GossipConfig as JGossipConfig
from repro.config import INPUT_SHAPES as JINPUT_SHAPES
from repro.config import get_config as jget_config
from repro.launch import specs as jspecs
from repro.models import transformer as JT
from repro.sharding import rules as jrules
from repro_torch import convert
from repro_torch.config import GossipConfig, INPUT_SHAPES, get_config
from repro_torch.configs import ARCH_IDS
from repro_torch.launch import mesh as M
from repro_torch.launch import specs
from repro_torch.models import transformer as T
from repro_torch.sharding import rules
from repro_torch.sharding.rules import PS, map_leaves


class _Mesh:
    """The reference's mesh as its rules read it: names and a shape."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _leaves(tree, is_leaf, path=()):
    if is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], is_leaf,
                                                         path + (k,))]
    return [x for i, t in enumerate(tree) for x in _leaves(t, is_leaf,
                                                           path + (i,))]


def _is_axes(x):
    return isinstance(x, tuple) and not isinstance(x, PS) and all(
        isinstance(e, (str, type(None))) for e in x)


def _is_ps(x):
    return type(x).__name__ == "PartitionSpec"


def _same_specs(port, ref):
    a = [(p, tuple(s)) for p, s in _leaves(port, _is_ps)]
    b = [(p, tuple(s)) for p, s in _leaves(ref, _is_ps)]
    assert [p for p, _ in a] == [p for p, _ in b]
    diff = [(p, x, y) for (p, x), (_, y) in zip(a, b) if x != y]
    assert not diff, diff[:5]
    return len(a)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_equal_the_reference(arch):
    ours = convert.lm_axes_to_reference(get_config(arch),
                                        T.param_axes(get_config(arch)))
    ref = JT.param_axes(jget_config(arch))
    a, b = _leaves(ours, _is_axes), _leaves(ref, _is_axes)
    assert [p for p, _ in a] == [p for p, _ in b]
    assert [x for _, x in a] == [tuple(x) for _, x in b]


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shardings_for_equal_the_reference(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    mesh = _Mesh(shape, names)
    cfg, jcfg = get_config(arch), jget_config(arch)
    n = 0
    for kw, jkw in ((dict(), dict()),
                    (dict(gossip=GossipConfig()),
                     dict(gossip=JGossipConfig())),
                    (dict(inference=True), dict(inference=True))):
        ours, rules_p = specs.shardings_for(cfg, mesh, **kw)
        ref, rules_r = jspecs.shardings_for(jcfg, mesh, **jkw)
        assert rules_p.name == rules_r.name
        assert rules_p.table == rules_r.table
        n += _same_specs(ours, ref)
    assert n > 0


def _decode_shapes(arch):
    out = []
    for name, shape in INPUT_SHAPES.items():
        if shape.kind != "decode":
            continue
        try:
            cfg, _ = specs.resolve_variant(get_config(arch), shape)
        except ValueError:                  # whisper x long_500k
            continue
        jcfg, _ = jspecs.resolve_variant(jget_config(arch),
                                         JINPUT_SHAPES[name])
        out.append((name, shape, cfg, jcfg))
    return out


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_equal_the_reference(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    mesh = _Mesh(shape, names)
    multi = "pod" in names
    cases = 0
    for name, sh, cfg, jcfg in _decode_shapes(arch):
        cache = T.cache_spec(cfg, sh.global_batch, sh.seq_len)
        stacked = convert.lm_params_to_reference(cfg, {"blocks": cache})
        ref_cache = JT.cache_spec(jcfg, sh.global_batch, sh.seq_len)
        for profile in ("context", "batch"):
            ours = rules.cache_pspecs(stacked, mesh, multi_pod=multi,
                                      profile=profile)
            ref = jrules.cache_pspecs(ref_cache, mesh, multi_pod=multi,
                                      profile=profile)
            cases += _same_specs(ours, ref)
    assert cases > 0


def _layer_sharded(arch, mesh_name):
    """The port's per-layer cache specs against the reference's stacked
    ones: each the reference's without its layer entry; returns the
    (shape, profile, leaf) where that entry is sharded."""
    shape, names = MESHES[mesh_name]
    mesh = _Mesh(shape, names)
    multi = "pod" in names
    out = []
    for name, sh, cfg, jcfg in _decode_shapes(arch):
        cache = T.cache_spec(cfg, sh.global_batch, sh.seq_len)
        for profile in ("context", "batch"):
            ref = jrules.cache_pspecs(
                JT.cache_spec(jcfg, sh.global_batch, sh.seq_len), mesh,
                multi_pod=multi, profile=profile)
            ours = specs.cache_specs(cfg, cache, mesh, profile=profile)
            period = len(cfg.layer_pattern)
            nb = cfg.num_layers // period
            for i, entry in enumerate(ours):
                for leaf, ps in entry.items():
                    if i >= nb * period:
                        want = ref["tail"][f"t{i - nb * period}"][leaf]
                        assert tuple(ps) == tuple(want)
                        continue
                    want = list(ref["blocks"][f"l{i % period}"][leaf])
                    if want and want[0] is not None:
                        out.append((name, profile, leaf))
                    want = want[1:]
                    while want and want[-1] is None:
                        want.pop()
                    assert tuple(ps) == tuple(want), (name, profile, i, leaf)
    return sorted(set(out))


# where the reference shards its layer stack itself (48 stacked layers
# over 'model' in both profiles, 'data' too in the batch one): the port's
# per-layer leaves have no layer axis, and leave that mesh axis unused
LAYER_SHARDED = {(arch, mesh): [(shape, profile, leaf)
                                for shape in ("decode_32k", "long_500k")
                                for profile in ("batch", "context")
                                for leaf in leaves]
                 for arch, leaves in (("mamba2-780m", ("conv", "ssm")),
                                      ("llama4-scout-17b-a16e", ("k", "v")))
                 for mesh in MESHES}


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_per_layer_cache_specs_drop_the_layer_entry(arch, mesh_name):
    assert _layer_sharded(arch, mesh_name) == \
        LAYER_SHARDED.get((arch, mesh_name), [])


# ---------------------------------------------------------------------------
# tests/test_sharding.py and tests/test_perf_profiles.py's rule cases, on
# both rule sets
# ---------------------------------------------------------------------------

SIZES = {"data": 16, "model": 16}
SIZES_MP = {"pod": 2, "data": 16, "model": 16}
RULE_CASES = [
    ("ffn_on_model", dict(), (4096, 12288), ("embed", "ffn"), SIZES),
    ("indivisible_heads", dict(), (5120, 40, 128),
     ("embed", "heads", "head_dim"), SIZES),
    ("kv8_on_16", dict(), (4096, 8, 128), ("embed", "kv_heads", "head_dim"),
     SIZES),
    ("small_replicated", dict(), (2048,), ("embed",), SIZES),
    ("expert_profile", dict(moe_sharding="expert"), (16, 5120, 8192),
     ("expert", "embed", "expert_ffn"), SIZES),
    ("tensor_profile", dict(moe_sharding="tensor"), (8, 6144, 16384),
     ("expert", "embed", "expert_ffn"), SIZES),
    ("no_double_use", dict(), (4096, 4096), ("ffn", "ffn"), SIZES),
    ("multi_pod_fsdp", dict(multi_pod=True), (16384, 53248),
     ("embed", "ffn"), SIZES_MP),
    ("gossip_peer_axes", dict(peer_axes=("data",)), (4096, 12288),
     ("embed", "ffn"), SIZES),
    ("embed_table", dict(), (151936, 2048), ("vocab", "embed_table"),
     SIZES),
    ("inference_2d_ffn", dict(inference=True), (4096, 12288),
     ("embed", "ffn"), SIZES),
    ("inference_heads", dict(inference=True), (16384, 128, 128),
     ("embed", "heads", "head_dim"), SIZES),
]
EXPECTED = {
    "ffn_on_model": PS("data", "model"),
    "indivisible_heads": PS("data"),
    "kv8_on_16": PS("data"),
    "small_replicated": PS(),
    "expert_profile": PS("model", "data"),
    "tensor_profile": PS(None, "data", "model"),
    "no_double_use": PS("model"),
    "multi_pod_fsdp": PS(("pod", "data"), "model"),
    "gossip_peer_axes": PS(None, "model"),
    "embed_table": PS("model"),
    "inference_2d_ffn": PS(None, ("model", "data")),
    "inference_heads": PS(None, "model", "data"),
}


@pytest.mark.parametrize("case", RULE_CASES, ids=lambda c: c[0])
def test_rule_case_equals_the_reference(case):
    name, kw, shape, axes, sizes = case
    ours = rules.partition_spec(shape, axes, sizes, rules.default_rules(**kw))
    ref = jrules.partition_spec(shape, axes, sizes,
                                jrules.default_rules(**kw))
    assert tuple(ours) == tuple(ref) == tuple(EXPECTED[name])


class _FakeMesh:
    axis_names = ("data", "model")

    class devices:
        shape = (16, 16)


CACHE_CASES = [
    ("context_length_and_batch", "context", "k", (36, 128, 32768, 8, 128)),
    ("batch_profile", "batch", "k", (36, 128, 32768, 8, 128)),
    ("context_falls_back_to_batch", "context", "ck", (128, 1500, 16, 64)),
    ("one_by_one_mesh", "context", "k", (2, 128, 32, 8, 128)),
]


@pytest.mark.parametrize("case", CACHE_CASES, ids=lambda c: c[0])
def test_cache_case_equals_the_reference(case):
    import jax
    import jax.numpy as jnp
    name, profile, leaf, shape = case
    mesh = ({"data": 1, "model": 1} if name == "one_by_one_mesh"
            else _FakeMesh())
    ours = rules.cache_pspecs({leaf: torch.empty(shape, device="meta")},
                              mesh, profile=profile)[leaf]
    jmesh = (jax.make_mesh((1, 1), ("data", "model"))
             if name == "one_by_one_mesh" else _FakeMesh())
    ref = jrules.cache_pspecs({leaf: jax.ShapeDtypeStruct(shape,
                                                          jnp.bfloat16)},
                              jmesh, profile=profile)[leaf]
    assert tuple(ours) == tuple(ref)
    if name == "context_length_and_batch":
        assert ours[2] == "data" and ours[1] == "model"
    if name == "batch_profile":
        assert ours[1] == "data"
    if name == "context_falls_back_to_batch":
        assert ours[0] == "data"


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
    assert rules.placements(PS(("pod", "data"), None, "model"), Mesh()) == \
        [Shard(0), Shard(0), Shard(2)]
    assert rules.placements(PS(), Mesh()) == [Replicate()] * 3


# ---------------------------------------------------------------------------
# the fake production groups
# ---------------------------------------------------------------------------


@pytest.fixture(params=[False, True], ids=["16x16", "2x16x16"])
def production(request):
    multi = request.param
    with M.fake_group(512 if multi else 256):
        yield multi, M.make_production_mesh(multi_pod=multi,
                                            device_type="cpu")
    import torch.distributed as dist
    assert not dist.is_initialized()


def _shard_shape(shape, ps, sizes):
    out = list(shape)
    for i, entry in enumerate(ps):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                out[i] //= sizes[a]
    return tuple(out)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_production_mesh_places_every_leaf_at_the_reference_shard(
        production, arch):
    multi, mesh = production
    names = ("pod", "data", "model") if multi else ("data", "model")
    sizes = dict(zip(names, (2, 16, 16) if multi else (16, 16)))
    assert M.mesh_axis_sizes(mesh) == sizes
    cfg = get_config(arch)
    ours, _ = specs.shardings_for(cfg, mesh)
    p_specs = specs.param_specs(cfg, ours)
    placed = rules.distribute_params(T.abstract_params(cfg), mesh, p_specs)
    ref, _ = jspecs.shardings_for(jget_config(arch),
                                  _Mesh(tuple(sizes.values()), names))
    ref_shapes = convert.lm_params_to_reference(cfg, T.abstract_params(cfg))
    want = map_leaves(lambda ps, t: _shard_shape(tuple(t.shape), tuple(ps),
                                                 sizes),
                      ref, ref_shapes, is_leaf=_is_ps)
    want = convert.lm_tree_from_reference(cfg, want,
                                          lambda s, _: s[1:])
    got = [(p, tuple(t.to_local().shape)) for p, t in
           _leaves(placed, lambda x: isinstance(x, torch.Tensor))]
    exp = _leaves(want, lambda x: isinstance(x, tuple))
    assert [p for p, _ in got] == [p for p, _ in exp]
    assert [s for _, s in got] == [s for _, s in exp]
    # the rules shard at production size: most of the weight is sharded
    total = sum(math.prod(t.shape) for _, t in _leaves(
        placed, lambda x: isinstance(x, torch.Tensor)))
    local = sum(math.prod(s) for _, s in got)
    assert local * 8 < total
    for _, t in _leaves(placed, lambda x: isinstance(x, torch.Tensor)):
        assert t.to_local().is_meta


def test_production_mesh_needs_the_fake_group():
    with pytest.raises(RuntimeError, match="start_fake_group"):
        M.make_production_mesh(multi_pod=False, device_type="cpu")
