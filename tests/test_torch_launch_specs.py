"""The port's launch surface against the JAX package, on the CPU: the
config classes (``InputShape``, ``INPUT_SHAPES``, ``MeshConfig``,
``TrainConfig``, ``ServeConfig``, ``RunConfig``), ``param_count`` and
``active_param_count`` of every architecture, ``model_flops_for`` on every
(architecture, shape), ``tests/test_roofline.py``'s cases, ``configs.ARCH_IDS``
and the llama3-405b config, ``core.__all__``, ``learners.predict``, the
wire-name helpers on every registered codec, ``tree_leaves_with_path``,
and the shape-only specs on ``meta`` tensors: ``resolve_variant``,
``input_specs``, ``cache_spec``, ``abstract_params``, the per-layer state
specs, the encoder-side inputs and ``make_mask``.

The port's parameter and decode-cache specs keep its own layout (the
layers as a list in order); ``convert.lm_params_to_reference`` stacks
them into the reference's (a cache as ``{"blocks": cache}``), which runs on
``meta`` tensors too, and there every leaf's path, shape and dtype must
equal the reference's ``ShapeDtypeStruct``'s. Everything here is
exact: shapes, dtypes, integer counts and names.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.config import INPUT_SHAPES as JINPUT_SHAPES
from repro.config import base as jbase
from repro.config import get_config as jget_config
from repro.config import reduced_config as jreduced_config
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.core import learners as jlearners
from repro.core import wire_codec as jwc
from repro.launch import roofline as jroofline
from repro.launch import specs as jspecs
from repro.models import attention as jattn
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.models import vision as jvision
from repro.utils import tree as jtree
import repro_torch.core as core
from repro_torch import convert
from repro_torch.config import INPUT_SHAPES, base, get_config, reduced_config
from repro_torch.configs import ARCH_IDS
from repro_torch.core import gossip_optimizer, learners
from repro_torch.core import wire_codec as wc
from repro_torch.launch import mesh, roofline, specs
from repro_torch.models import attention as attn
from repro_torch.models import rglru, ssm, vision
from repro_torch.models import transformer as T
from repro_torch.utils.tree import tree_leaves_with_path

CLASSES = ("InputShape", "MeshConfig", "TrainConfig", "ServeConfig",
           "RunConfig", "GossipConfig")


def port_cfg(jcfg):
    return convert.model_config_from_dict(dataclasses.asdict(jcfg))


def dtype_name(dt) -> str:
    return str(dt)[6:] if isinstance(dt, torch.dtype) else np.dtype(dt).name


def jax_leaves(tree):
    """The reference tree's (path, shape, dtype) leaves, each path key
    as its plain key or index."""
    out = []
    for path, leaf in jtree.tree_leaves_with_path(tree):
        keys = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        out.append((keys, tuple(leaf.shape), dtype_name(leaf.dtype)))
    return out


def port_leaves(tree):
    """The port tree's (path, shape, dtype) leaves, each on ``meta``."""
    out = []
    for path, leaf in tree_leaves_with_path(tree):
        assert leaf.device.type == "meta", path
        out.append((path, tuple(leaf.shape), dtype_name(leaf.dtype)))
    return out


def to_reference(cfg, cache):
    """A decode cache in the port's layout stacked into the reference's."""
    return convert.lm_params_to_reference(cfg, {"blocks": cache})


def fields_of(cls):
    return [(f.name, str(f.type),
             f.default if f.default is not dataclasses.MISSING else None,
             f.default_factory is not dataclasses.MISSING)
            for f in dataclasses.fields(cls)]


# ---------------------------------------------------------------------------
# the package surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CLASSES)
def test_config_classes_match_reference_field_by_field(name):
    cls, jcls = getattr(base, name), getattr(jbase, name)
    assert fields_of(cls) == fields_of(jcls)
    for f, jf in zip(dataclasses.fields(cls), dataclasses.fields(jcls)):
        if f.default_factory is not dataclasses.MISSING:
            assert dataclasses.asdict(f.default_factory()) == \
                dataclasses.asdict(jf.default_factory())


def test_input_shapes_and_mesh_match_reference():
    assert list(INPUT_SHAPES) == list(JINPUT_SHAPES)
    for k, v in INPUT_SHAPES.items():
        assert dataclasses.asdict(v) == dataclasses.asdict(JINPUT_SHAPES[k])
    for kw in ({}, {"pods": 2}, {"data": 4, "model": 2}):
        m, jm = base.MeshConfig(**kw), jbase.MeshConfig(**kw)
        assert (m.multi_pod, m.num_devices) == (jm.multi_pod, jm.num_devices)
    run = base.RunConfig(get_config("qwen3-1.7b"))
    assert dataclasses.asdict(run.train) == dataclasses.asdict(
        jbase.RunConfig(jget_config("qwen3-1.7b")).train)


def test_exports_match_reference():
    import repro.config as jconfig
    import repro_torch.config as config
    assert config.__all__ == jconfig.__all__
    assert core.__all__ == jcore.__all__
    for name in core.__all__:
        assert getattr(core, name) is not None
    # ``merge`` is the function, as in the reference, not its module
    assert callable(core.merge) and core.merge.__name__ == "merge"
    assert core.run_sharded_simulation.__module__ == \
        "repro_torch.core.sharded_engine"
    # the peer mesh's cycle, no longer a raise
    assert core.linear_gossip_mesh_step is \
        gossip_optimizer.linear_gossip_mesh_step
    assert ARCH_IDS == JARCH_IDS


def test_llama3_405b_is_the_published_config():
    cfg, jcfg = get_config("llama3-405b"), jget_config("llama3-405b")
    assert cfg == port_cfg(jcfg).replace(attn_impl="flash")
    a = cfg.attention
    assert (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == (
        126, 16_384, 53_248, 128_256)
    assert (a.num_heads, a.num_kv_heads, a.head_dim, a.rope_theta) == (
        128, 8, 128, 5e5)
    assert not cfg.tie_embeddings and cfg.param_dtype == torch.bfloat16
    assert "2407.21783" in cfg.citation
    assert reduced_config(cfg) == port_cfg(jreduced_config(jcfg)).replace(
        attn_impl="flash")


@pytest.mark.parametrize("arch", JARCH_IDS)
def test_param_counts_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    for name, shape in INPUT_SHAPES.items():
        assert roofline.model_flops_for(cfg, shape) == \
            jroofline.model_flops_for(jcfg, JINPUT_SHAPES[name])


def test_model_flops_dense_vs_moe():
    dense = get_config("qwen3-8b")
    moe = get_config("mixtral-8x22b")
    sh = INPUT_SHAPES["train_4k"]
    toks = sh.global_batch * sh.seq_len
    np.testing.assert_allclose(roofline.model_flops_for(dense, sh),
                               6.0 * dense.param_count() * toks)
    assert moe.active_param_count() < 0.45 * moe.param_count()
    assert roofline.model_flops_for(moe, sh) == \
        6.0 * moe.active_param_count() * toks


def test_param_counts_plausible():
    cases = {"qwen3-8b": (7e9, 10e9), "qwen3-1.7b": (1.4e9, 2.4e9),
             "llama3-405b": (3.7e11, 4.4e11), "mamba2-780m": (6e8, 9e8),
             "mixtral-8x22b": (1.2e11, 1.6e11)}
    for arch, (lo, hi) in cases.items():
        n = get_config(arch).param_count()
        assert lo < n < hi, f"{arch}: {n:.3e} outside [{lo:.0e},{hi:.0e}]"


def test_decode_model_flops_counts_one_token():
    cfg = get_config("qwen3-1.7b")
    sh = INPUT_SHAPES["decode_32k"]
    assert roofline.model_flops_for(cfg, sh) == \
        2.0 * cfg.active_param_count() * sh.global_batch


def test_roofline_constants_are_the_cards():
    # NVIDIA H100 80GB HBM3 (SXM5), dense bf16 and HBM3, as PERF.md uses
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW) == (989e12, 3.35e12)
    assert [f.name for f in dataclasses.fields(roofline.Roofline)] == \
        [f.name for f in dataclasses.fields(jroofline.Roofline)]
    assert [f.name for f in dataclasses.fields(roofline.CollectiveStats)] == \
        [f.name for f in dataclasses.fields(jroofline.CollectiveStats)]


def test_predict_matches_reference():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((7, 10)).astype(np.float32)
    x = rng.standard_normal((7, 10)).astype(np.float32)
    x[0] = 0.0                                   # a zero score: sign 0
    want = np.asarray(jlearners.predict(jnp.asarray(w), jnp.asarray(x)))
    got = learners.predict(torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 0.0


@pytest.mark.parametrize("name", [None, "", "f32"] + sorted(jwc.WIRE_CODECS))
def test_wire_helpers_match_reference(name):
    assert sorted(wc.WIRE_CODECS) == sorted(jwc.WIRE_CODECS)
    dt, jdt = wc.resolve_wire_dtype(name), jwc.resolve_wire_dtype(name)
    assert (dt is None) == (jdt is None)
    if dt is not None:
        assert dtype_name(dt) == dtype_name(jdt)
    for fn in ("is_quantized_wire", "is_stochastic_wire", "wire_itemsize",
               "wire_overhead_bytes"):
        assert getattr(wc, fn)(name) == getattr(jwc, fn)(name), fn


def test_tree_leaves_with_path_matches_reference():
    tree = {"b": [np.zeros(2), {"y": np.ones(3), "x": np.ones(1)}],
            "a": {"k": np.zeros((2, 2))}}
    want = [(p, s) for p, s, _ in jax_leaves(tree)]
    ttree = {"b": [torch.zeros(2), {"y": torch.ones(3), "x": torch.ones(1)}],
             "a": {"k": torch.zeros((2, 2))}}
    got = [(p, tuple(x.shape)) for p, x in tree_leaves_with_path(ttree)]
    assert got == want


# ---------------------------------------------------------------------------
# specs on meta tensors
# ---------------------------------------------------------------------------


def resolved(arch, shape_name):
    """Both packages' ``resolve_variant``: (port cfg, notes, JAX cfg,
    notes), or the ``ValueError`` message of both."""
    jcfg, shape = jget_config(arch), JINPUT_SHAPES[shape_name]
    try:
        jcfg, jnotes = jspecs.resolve_variant(jcfg, shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            specs.resolve_variant(get_config(arch), INPUT_SHAPES[shape_name])
        assert str(got.value) == str(e)
        return None
    cfg, notes = specs.resolve_variant(get_config(arch),
                                       INPUT_SHAPES[shape_name])
    return cfg, notes, jcfg, jnotes


@pytest.mark.parametrize("shape_name", list(JINPUT_SHAPES))
@pytest.mark.parametrize("arch", JARCH_IDS)
def test_input_specs_match_reference(arch, shape_name):
    r = resolved(arch, shape_name)
    if r is None:
        assert (arch, shape_name) == ("whisper-medium", "long_500k")
        return
    cfg, notes, jcfg, jnotes = r
    assert notes == jnotes
    assert cfg == port_cfg(jcfg).replace(attn_impl="flash")
    shape, jshape = INPUT_SHAPES[shape_name], JINPUT_SHAPES[shape_name]
    for peers in ((0, 16) if shape.kind == "train" else (0,)):
        got = specs.input_specs(cfg, shape, n_peers=peers)
        want = jspecs.input_specs(jcfg, jshape, n_peers=peers)
        assert sorted(got) == sorted(want)
        if "cache" in got:
            assert len(got["cache"]) == cfg.num_layers
            got = dict(got, cache=to_reference(cfg, got["cache"]))
        assert port_leaves(got) == jax_leaves(want)
    assert specs.needs_encoder_input(cfg) == jspecs.needs_encoder_input(jcfg)


@pytest.mark.parametrize("arch", JARCH_IDS)
def test_abstract_params_and_cache_spec_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    got = port_leaves(convert.lm_params_to_reference(
        cfg, T.abstract_params(cfg)))
    assert got == jax_leaves(JT.abstract_params(jcfg))
    assert sum(np.prod(s) for _, s, _ in got) == jcfg.param_count()
    for window in (None, 16):
        spec = T.cache_spec(cfg, 3, 40, window=window)
        assert port_leaves(to_reference(cfg, spec)) == \
            jax_leaves(JT.cache_spec(jcfg, 3, 40, window=window))


def test_init_cache_materialises_cache_spec():
    cfg = reduced_config(get_config("recurrentgemma-9b"))
    spec = T.cache_spec(cfg, 2, 48, window=20)
    cache = T.init_cache(cfg, 2, 48, window=20, device="cpu")
    for (p, s), (q, c) in zip(tree_leaves_with_path(spec),
                              tree_leaves_with_path(cache)):
        assert p == q and c.device.type == "cpu" and not c.any()
        assert (c.shape, c.dtype) == (s.shape, s.dtype)


def test_layer_state_specs_match_reference():
    jr = jreduced_config(jget_config("recurrentgemma-9b"))
    js = jreduced_config(jget_config("mamba2-780m"))
    r, s = port_cfg(jr), port_cfg(js)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        assert port_leaves(ssm.ssm_state_spec(3, s.d_model, s.ssm, dt)) == \
            jax_leaves(jssm.ssm_state_spec(3, js.d_model, js.ssm, jdt))
        assert port_leaves(rglru.rglru_state_spec(3, r.d_model, r.rglru,
                                                  dt)) == \
            jax_leaves(jrglru.rglru_state_spec(3, jr.d_model, jr.rglru, jdt))
        assert port_leaves(attn.kv_cache_spec(3, 9, r.attention, dt)) == \
            jax_leaves(jattn.kv_cache_spec(3, 9, jr.attention, jdt))


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-medium"])
def test_encoder_input_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    fn = "patch_embedding_spec" if cfg.family == "vlm" else \
        "frame_embedding_spec"
    for got, want in ((getattr(vision, fn)(cfg, 3),
                       getattr(jvision, fn)(jcfg, 3)),
                      (specs.encoder_input_spec(cfg, 5),
                       jspecs.encoder_input_sds(jcfg, 5))):
        assert got.device.type == "meta"
        assert (tuple(got.shape), dtype_name(got.dtype)) == (
            tuple(want.shape), dtype_name(want.dtype))


@pytest.mark.parametrize("causal,window", [(True, None), (True, 3),
                                           (False, None), (False, 4)])
def test_make_mask_matches_reference(causal, window):
    ja = jbase.AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=8,
                               causal=causal, sliding_window=window)
    a = base.AttentionConfig(**dataclasses.asdict(ja))
    q = np.array([0, 3, 4, 9], np.int32)
    k = np.arange(10, dtype=np.int32)
    want = np.asarray(jattn.make_mask(ja, jnp.asarray(q), jnp.asarray(k)))
    got = attn.make_mask(a, torch.from_numpy(q), torch.from_numpy(k))
    assert got.dtype == torch.bool and got.shape == (1, 1, 4, 10)
    np.testing.assert_array_equal(got.numpy(), want)
