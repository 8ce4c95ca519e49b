"""The LM serving path of the port against the JAX package, on the CPU.

Reduced ``qwen3-1.7b`` (GQA 2:1), ``qwen3-8b`` (GQA 4:1) and
``llama3-405b`` (GQA 16:1, no qk-norm) configs, the port's seeded weights
carried to the JAX package by ``convert.lm_params_to_arrays``: the
configs field by field, the layers (``rmsnorm``, ``mlp``, ``apply_rope``,
``attention`` on the plain and the flash path, ``decode_attention`` plain
and on a ring), the fused ``prefill`` with every cache entry, and the
port's ``DecodeServer`` against the JAX ``DecodeServer`` with
``attn_impl="pallas"`` (its flash kernel in interpret mode): fused,
token-by-token and ring-window prefill, a prompt that is no multiple of
either kernel's block, and greedy tokens equal over 8 decode steps.

Float tolerance: everything runs in f32 on both sides and differs only in
the order of sums (XLA's against PyTorch's, and the flash kernel's online
softmax against the plain one), so logits, cache entries and layer outputs
agree within rtol 1e-4 and an atol of 1e-5 times the largest magnitude
compared (at least 1): the random layers' outputs reach ~100, where f32
sums in another order differ by ~5e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jget_config
from repro.config import reduced_config as jreduced_config
from repro.launch.serve import DecodeServer as JServer
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.config import get_config, list_configs, reduced_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.launch.serve import DecodeServer
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.utils.tree import tree_map

ARCHS = ["qwen3-1.7b", "qwen3-8b", "llama3-405b"]
RTOL, ATOL = 1e-4, 1e-5


def close(got, want):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=RTOL, atol=ATOL * scale)


def jax_and_port(arch, vocab=512, impl="pallas"):
    """The reduced JAX config with ``impl``, its port, the port's params
    from a generator seeded with 0 on the CPU, and the JAX package's copy
    of them (moved by ``convert.lm_params_to_arrays``: the reference's own
    ``init_params`` seeds its leaves with Python's per-process string
    hash, so its weights change from run to run)."""
    jcfg = jreduced_config(jget_config(arch), vocab=vocab).replace(
        attn_impl=impl)
    cfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))
    params = T.init_params(cfg, device="cpu", seed=0)
    jp = jax.tree.map(jnp.asarray, convert.lm_params_to_arrays(cfg, params))
    return jcfg, cfg, jp, params


def port_asdict(cfg):
    d = dataclasses.asdict(cfg)
    return {k: (str(v) if isinstance(v, torch.dtype) else v)
            for k, v in d.items()}


def ref_asdict(jcfg):
    d = dataclasses.asdict(jcfg)
    for k in ("param_dtype", "compute_dtype"):
        d[k] = f"torch.{np.dtype(d[k]).name}"
    return d


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen3-4b", "qwen3-8b",
                                  "llama3-405b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match_reference_field_by_field(arch, reduced):
    jcfg, cfg = jget_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jreduced_config(jcfg), reduced_config(cfg)
    want = ref_asdict(jcfg)
    got = port_asdict(cfg)
    assert (want.pop("attn_impl"), got.pop("attn_impl")) == ("chunked",
                                                             "flash")
    assert got == want
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.layer_kinds() == jcfg.layer_kinds()


def test_config_conversion():
    jcfg = jget_config("qwen3-1.7b").replace(attn_impl="pallas")
    cfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))
    assert cfg == get_config("qwen3-1.7b")
    assert cfg.param_dtype == torch.bfloat16
    assert cfg.compute_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        convert.model_config_from_dict({**dataclasses.asdict(jcfg), "x": 1})


def test_registry_names_what_is_not_ported():
    assert list_configs() == ["llama-3.2-vision-11b", "llama3-405b",
                              "llama4-scout-17b-a16e", "mamba2-780m",
                              "mixtral-8x22b", "qwen3-1.7b", "qwen3-4b",
                              "qwen3-8b", "recurrentgemma-9b",
                              "whisper-medium"]
    # the last architecture to be refused is served now
    want = convert.model_config_from_dict(dataclasses.asdict(
        jget_config("llama3-405b")))
    assert get_config("llama3-405b") == want.replace(attn_impl="flash")
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    # the audio family, the last to be refused, now has a spec
    audio = jreduced_config(jget_config("whisper-medium"))
    spec = T.model_spec(convert.model_config_from_dict(
        dataclasses.asdict(audio)))
    assert {"encoder", "pos_embed"} <= set(spec)


def test_params_carry_across_bf16_by_their_bits():
    jcfg = jreduced_config(jget_config("qwen3-1.7b")).replace(
        param_dtype=jnp.bfloat16)
    cfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))
    jp = JT.init_params(jax.random.key(2), jcfg)
    params = convert.lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jp),
                                           "cpu")
    wq = params["blocks"][1]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    want = np.asarray(jp["blocks"]["l0"]["attn"]["wq"][1])
    assert np.array_equal(wq.view(torch.int16).numpy(),
                          want.view(np.int16))
    assert sum(p.numel() for p in params.parameters()) == jcfg.param_count()


def test_init_params_draws_from_a_generator():
    cfg = reduced_config(get_config("qwen3-8b"))
    make = lambda: T.init_params(cfg, device="cpu", seed=5)
    a, b = make(), make()
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name
    assert not any(p.requires_grad for p in a.parameters())
    assert float(a["blocks"][0]["ln1"]["scale"].min()) == 1.0
    assert "lm_head" in a and "lm_head" not in T.init_params(
        reduced_config(get_config("qwen3-1.7b")), device="cpu")


def test_entry_points_need_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = reduced_config(get_config("qwen3-1.7b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced"])


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_norms_and_mlp_match_reference(act):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 32), dtype=np.float32)
    spec = {"n": layers.rmsnorm_spec(32), "ln": layers.layernorm_spec(32),
            "m": layers.mlp_spec(32, 48, act)}
    # the port's leaves from a seeded generator (the reference's own
    # init_params seeds by Python's per-process string hash)
    jp = jax.tree.map(jnp.asarray, tree_map(convert._np, layers.init_params(
        spec, torch.Generator().manual_seed(1), "cpu")))
    jp["n"]["scale"] = jnp.asarray(rng.standard_normal(32), jnp.float32)
    jp["ln"]["bias"] = jnp.asarray(rng.standard_normal(32), jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    p = layers.build_params(
        spec, lambda path, _: torch.tensor(tree[path[0]][path[1]]))
    xt = torch.from_numpy(x)
    close(layers.rmsnorm(p["n"], xt), jlayers.rmsnorm(jp["n"], x))
    close(layers.layernorm(p["ln"], xt), jlayers.layernorm(jp["ln"], x))
    close(layers.mlp(p["m"], xt, act), jlayers.mlp(jp["m"], x, act))


def test_rope_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 3, 16), dtype=np.float32)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    for theta in (1e4, 1e6):
        close(attn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              theta),
              jattn.apply_rope(x, pos, theta))


def layer0(arch, impl="pallas", window=None):
    jcfg, cfg, jp, params = jax_and_port(arch, impl=impl)
    if window is not None:
        jcfg = jcfg.replace(attention=dataclasses.replace(
            jcfg.attention, sliding_window=window))
        cfg = cfg.replace(attention=dataclasses.replace(
            cfg.attention, sliding_window=window))
    return (jcfg.attention, cfg.attention,
            jax.tree.map(lambda a: a[0], jp["blocks"]["l0"]["attn"]),
            params["blocks"][0]["attn"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl,window", [("xla", None), ("pallas", None),
                                         ("pallas", 6)])
def test_attention_matches_reference(arch, impl, window):
    ja, a, jp, p = layer0(arch, window=window)
    x = np.random.default_rng(3).standard_normal((2, 19, 256),
                                                 dtype=np.float32)
    jout, (jk, jv) = jattn.attention(jp, ja, x, compute_dtype=jnp.float32,
                                     impl=impl, return_kv=True)
    port_impl = "flash" if impl == "pallas" else impl
    out, (k, v) = attn.attention(p, a, torch.from_numpy(x),
                                 compute_dtype=torch.float32,
                                 impl=port_impl, return_kv=True)
    close(out, jout)
    close(k, jk)
    close(v, jv)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("slots,ring", [(16, False), (6, True)])
def test_decode_attention_matches_reference(arch, slots, ring):
    """Ten steps from a random cache: plain (16 slots) and a 6-slot ring,
    which wraps."""
    ja, a, jp, p = layer0(arch)
    rng = np.random.default_rng(4)
    kv = (2, slots, a.num_kv_heads, a.head_dim)
    jc = {n: jnp.asarray(rng.standard_normal(kv, dtype=np.float32))
          for n in ("k", "v")}
    cache = {n: torch.from_numpy(np.array(jc[n])) for n in ("k", "v")}
    for index in range(10):
        x = rng.standard_normal((2, 1, 256), dtype=np.float32)
        jout, jc = jattn.decode_attention(jp, ja, x, jc, jnp.int32(index),
                                          compute_dtype=jnp.float32,
                                          window=slots if ring else None)
        out, cache = attn.decode_attention(p, a, torch.from_numpy(x), cache,
                                           index, compute_dtype=torch.float32,
                                           window=slots if ring else None)
        close(out, jout)
        close(cache["k"], jc["k"])
        close(cache["v"], jc["v"])


def jcache_layers(jcache, n):
    """The JAX cache's stacked ``blocks/l0`` entries, one per layer."""
    return [{name: np.asarray(jcache["blocks"]["l0"][name][i])
             for name in ("k", "v")} for i in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("prompt,cache_len,window", [(19, 32, None),
                                                     (13, 24, 8)])
def test_prefill_matches_reference(arch, prompt, cache_len, window):
    jcfg, cfg, jp, params = jax_and_port(arch)
    toks = np.random.default_rng(5).integers(0, 512, (2, prompt))
    jlogits, jcache = JT.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                 cache_len, window=window)
    fa_before = fa.flash_attention.launches
    logits, cache = T.prefill(params, cfg, torch.from_numpy(toks), cache_len,
                              window=window)
    assert fa.flash_attention.launches == fa_before    # CPU: plain version
    close(logits, jlogits)
    assert len(cache) == cfg.num_layers
    for got, want in zip(cache, jcache_layers(jcache, cfg.num_layers)):
        for name in ("k", "v"):
            assert tuple(got[name].shape) == want[name].shape
            close(got[name], want[name])
    if window is None:      # the forward pass has no ring window
        last, _ = T.forward(params, cfg, torch.from_numpy(toks),
                            last_only=True)
        close(last, jlogits)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["fused", "sequential", "ring", "ragged"])
def test_decode_server_matches_reference(arch, mode):
    """The port's server against the JAX server with the Pallas flash
    kernel: prefill logits within tolerance and the same greedy tokens
    over 8 steps. ``ring``: a window of 8 under a 13-token prompt (the
    fused pass must drop the evicted keys); ``ragged``: a 200-token prompt,
    no multiple of the JAX kernel's 128-key block nor of the port's."""
    jcfg, cfg, jp, params = jax_and_port(arch)
    prompt, max_len, window = {"fused": (40, 64, None),
                               "sequential": (12, 32, None),
                               "ring": (13, 24, 8),
                               "ragged": (200, 224, None)}[mode]
    kw = dict(batch=2, max_len=max_len, window=window,
              fused_prefill=mode != "sequential")
    prompts = np.random.default_rng(6).integers(0, 512, (2, prompt))
    js = JServer(jcfg, jp, **kw)
    jlogits, start = js.prefill(prompts)
    jtoks = js.decode(jlogits, start, 8)
    srv = DecodeServer(cfg, params, **kw)
    logits, start2 = srv.prefill(prompts)
    close(logits, jlogits)
    assert start2 == start
    toks = srv.decode(logits, start2, 8)
    np.testing.assert_array_equal(toks, jtoks)
    for got, want in zip(srv.cache, jcache_layers(js.cache, cfg.num_layers)):
        close(got["k"], want["k"])


def test_serve_cli_runs_reduced_on_the_cpu(capsys):
    serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--decode-steps", "4", "--max-len", "16"])
    out = capsys.readouterr().out
    assert "arch=qwen3-1.7b-smoke device=cpu batch=2" in out
