"""The moe, ssm and hybrid families of the port's LM stack against the JAX
package, on the CPU.

Reduced ``mixtral-8x22b`` (MoE, 4 experts top-2, GQA 6:1, window 64),
``llama4-scout-17b-a16e`` (MoE top-1, GQA 5:1, window 64),
``mamba2-780m`` (SSD; the reduced config gives it an FFN, as the
reference's does) and ``recurrentgemma-9b`` (rglru, rglru, local with
window 32, MQA), the port's seeded weights carried to the JAX package by
``convert.lm_params_to_arrays``: the configs field by field, the
``"banded"`` attention against the reference's ``_banded_sdpa``,
``forward`` (with the MoE aux) and ``lm_loss``'s value, the fused
``prefill`` with every cache entry (moved by
``convert.lm_cache_from_arrays``), the MoE router's choices, keep mask
and ``drop_fraction`` in a layer of the model, the port's
``DecodeServer`` against the JAX ``DecodeServer`` with
``attn_impl="pallas"`` (its flash kernel in interpret mode), fused and
token by token, and the port's fused prefill against its own
token-by-token decode. Every prompt (80 tokens) is longer than the
reduced windows, so the attention caches are rings that have wrapped.

Float tolerance: float32 on both sides, differing in the order of sums.
These configs have no qk-norm, so their attention logits are larger and
their softmax sharper than the reduced qwen3's: measured, the forward
logits of the reduced mixtral, llama4-scout and recurrentgemma differ
from the reference's by up to 1.3e-4, 1.3e-4 and 1.5e-4 of their
largest magnitude (mamba2 9e-6), cache entries by up to 5.1e-5. The bar
is rtol 1e-4 and an atol of 5e-4 times the largest magnitude compared;
greedy tokens must be equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jget_config
from repro.config import reduced_config as jreduced_config
from repro.config.base import AttentionConfig as JAttentionConfig
from repro.launch.serve import DecodeServer as JServer
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.config import get_config, list_configs, reduced_config
from repro_torch.config.base import AttentionConfig
from repro_torch.configs import ARCH_IDS
from repro_torch.launch import serve
from repro_torch.launch.serve import DecodeServer
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import transformer as T

ARCHS = ["mixtral-8x22b", "llama4-scout-17b-a16e", "mamba2-780m",
         "recurrentgemma-9b"]
MOE_ARCHS = ARCHS[:2]
RTOL, ATOL = 1e-4, 5e-4
PROMPT, MAX_LEN, STEPS = 80, 96, 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs (many small ops; a thread
    pool costs more than it gains beside other pytest workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=RTOL, atol=ATOL * scale)


@functools.lru_cache(maxsize=None)
def jax_and_port(arch, impl="pallas"):
    """The reduced JAX config with ``impl``, its port, the port's params
    from a generator seeded with 0 on the CPU, and the JAX package's copy
    of them (moved by ``convert.lm_params_to_arrays``: the reference's own
    ``init_params`` seeds its leaves with Python's per-process string
    hash, so its weights, and whether a comparison's f32 noise stays
    inside the bar, would change from run to run)."""
    jcfg = jreduced_config(jget_config(arch), vocab=512).replace(
        attn_impl=impl)
    cfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))
    params = T.init_params(cfg, device="cpu", seed=0)
    jp = jax.tree.map(jnp.asarray, convert.lm_params_to_arrays(cfg, params))
    return jcfg, cfg, jp, params


def prompts(seed, n=PROMPT):
    return np.random.default_rng(seed).integers(0, 512, (2, n))


def port_asdict(cfg):
    d = dataclasses.asdict(cfg)
    return {k: (str(v) if isinstance(v, torch.dtype) else v)
            for k, v in d.items()}


def ref_asdict(jcfg):
    d = dataclasses.asdict(jcfg)
    for k in ("param_dtype", "compute_dtype"):
        d[k] = f"torch.{np.dtype(d[k]).name}"
    return d


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match_reference_field_by_field(arch, reduced):
    jcfg, cfg = jget_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jreduced_config(jcfg), reduced_config(cfg)
    want, got = ref_asdict(jcfg), port_asdict(cfg)
    assert (want.pop("attn_impl"), got.pop("attn_impl")) == ("chunked",
                                                             "flash")
    assert got == want
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.layer_kinds() == jcfg.layer_kinds()


def test_registry_serves_the_new_families():
    # every architecture of the reference is served: none is refused
    assert sorted(ARCH_IDS) == list_configs()
    assert set(ARCHS) <= set(list_configs())
    for arch in ARCHS:
        assert get_config(arch).name == arch


@pytest.mark.parametrize("s,window,chunk,h,kv", [
    (80, 64, 16, 6, 1), (80, 64, 512, 6, 1), (37, 8, 4, 4, 2),
    (100, 32, 24, 4, 4), (19, 64, 8, 2, 1)])
def test_banded_matches_reference(s, window, chunk, h, kv):
    """``_banded_sdpa`` over ragged and whole blocks, spans shorter and
    longer than S, against the reference's."""
    rng = np.random.default_rng(s + window)
    q = rng.standard_normal((2, s, h, 16), dtype=np.float32)
    k = rng.standard_normal((2, s, kv, 16), dtype=np.float32)
    v = rng.standard_normal((2, s, kv, 16), dtype=np.float32)
    pos = np.arange(s, dtype=np.int32)
    ja = JAttentionConfig(num_heads=h, num_kv_heads=kv, head_dim=16,
                          sliding_window=window)
    a = AttentionConfig(**dataclasses.asdict(ja))
    want = jattn._banded_sdpa(q, k, v, ja, pos, jnp.float32, chunk)
    tq, tk, tv, tpos = map(torch.from_numpy, (q, k, v, pos))
    got = attn._banded_sdpa(tq, tk, tv, a, tpos, torch.float32, chunk)
    close(got, want)
    # the band equals the masked full attention
    full = attn._grouped_sdpa(tq, tk, tv, a, tpos, tpos, torch.float32)
    close(got, full.numpy())


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "recurrentgemma-9b"])
def test_banded_impl_runs_the_model(arch):
    """``attn_impl="banded"`` through the model's attention layers: the
    reference's banded forward, and the port's own flash forward."""
    jcfg, cfg, jp, params = jax_and_port(arch)
    toks = prompts(11)
    want, _ = JT.forward(jp, jcfg.replace(attn_impl="banded",
                                          attn_chunk=16),
                         jnp.asarray(toks, jnp.int32))
    got, _ = T.forward(params, cfg.replace(attn_impl="banded",
                                           attn_chunk=16),
                       torch.from_numpy(toks))
    close(got, want)
    flash, _ = T.forward(params, cfg, torch.from_numpy(toks))
    close(got, flash.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    jcfg, cfg, jp, params = jax_and_port(arch)
    toks = prompts(1)
    labels = np.roll(toks, -1, axis=1)
    jlogits, jaux = JT.forward(jp, jcfg, jnp.asarray(toks, jnp.int32))
    logits, aux = T.forward(params, cfg, torch.from_numpy(toks))
    close(logits, jlogits)
    close(aux, jaux)
    assert (float(aux) > 0) == (arch in MOE_ARCHS)
    jloss, jparts = JT.lm_loss(jp, jcfg, jnp.asarray(toks, jnp.int32),
                               jnp.asarray(labels, jnp.int32), seq_chunk=40)
    loss, parts = T.lm_loss(params, cfg, torch.from_numpy(toks),
                            torch.from_numpy(labels), seq_chunk=40)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(parts["aux"]), float(jparts["aux"]),
                               rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_matches_reference(arch):
    jcfg, cfg, jp, params = jax_and_port(arch)
    toks = prompts(2)
    jlogits, jcache = JT.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                 MAX_LEN)
    logits, cache = T.prefill(params, cfg, torch.from_numpy(toks), MAX_LEN)
    close(logits, jlogits)
    want = convert.lm_cache_from_arrays(cfg, jax.tree.map(np.asarray,
                                                          jcache), "cpu")
    empty = T.init_cache(cfg, 2, MAX_LEN, device="cpu")
    assert len(cache) == len(want) == len(empty) == cfg.num_layers
    for got_l, want_l, empty_l in zip(cache, want, empty):
        assert sorted(got_l) == sorted(want_l) == sorted(empty_l)
        for name in want_l:
            assert got_l[name].shape == want_l[name].shape \
                == empty_l[name].shape
            assert got_l[name].dtype == want_l[name].dtype \
                == empty_l[name].dtype
            close(got_l[name], want_l[name].numpy())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_routing_in_the_model_matches_reference(arch):
    """Layer 1's MoE FFN of the reduced model at a capacity factor that
    drops assignments, on a seeded input: the experts, the keep mask and
    ``drop_fraction`` equal to the reference's."""
    jcfg, cfg, jp, params = jax_and_port(arch)
    jm = dataclasses.replace(jcfg.moe, capacity_factor=0.5)
    m = dataclasses.replace(cfg.moe, capacity_factor=0.5)
    jffn = jax.tree.map(lambda a: a[1], jp["blocks"]["l0"]["ffn"])
    ffn = params["blocks"][1]["ffn"]
    x = np.random.default_rng(3).standard_normal((2, PROMPT, cfg.d_model),
                                                 dtype=np.float32)
    jout, jaux = jmoe.moe_ffn(jffn, jm, jnp.asarray(x), jcfg.act)
    out, aux = moe.moe_ffn(ffn, m, torch.from_numpy(x), cfg.act)
    close(out, jout)
    assert float(aux["drop_fraction"]) == float(jaux["drop_fraction"]) > 0
    probs, _, experts, slot, keep, c = moe.route(ffn, m, torch.from_numpy(x))
    jlogits = (jnp.asarray(x).reshape(1, -1, cfg.d_model)
               @ jffn["router"])
    _, jexperts = jax.lax.top_k(jax.nn.softmax(jlogits, axis=-1),
                                jm.top_k)
    np.testing.assert_array_equal(experts.numpy(), np.asarray(jexperts))
    assert c == jmoe._capacity(2 * PROMPT, jm)
    flat = np.asarray(jexperts).reshape(-1)
    jslot = np.array([np.sum(flat[:i] == e) for i, e in enumerate(flat)])
    np.testing.assert_array_equal(slot.numpy().reshape(-1), jslot)
    np.testing.assert_array_equal(keep.numpy().reshape(-1), jslot < c)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fused", [True, False])
def test_decode_server_matches_reference(arch, fused):
    """The port's server against the JAX server with the Pallas flash
    kernel: prefill logits within tolerance, the same greedy tokens over
    8 steps, and the caches after them."""
    jcfg, cfg, jp, params = jax_and_port(arch)
    kw = dict(batch=2, max_len=MAX_LEN, fused_prefill=fused)
    toks = prompts(6)
    js = JServer(jcfg, jp, **kw)
    jlogits, start = js.prefill(toks)
    jtoks = js.decode(jlogits, start, STEPS)
    srv = DecodeServer(cfg, params, **kw)
    logits, start2 = srv.prefill(toks)
    close(logits, jlogits)
    assert start2 == start
    np.testing.assert_array_equal(srv.decode(logits, start2, STEPS), jtoks)
    want = convert.lm_cache_from_arrays(cfg, jax.tree.map(np.asarray,
                                                          js.cache), "cpu")
    for got_l, want_l in zip(srv.cache, want):
        for name in want_l:
            close(got_l[name], want_l[name].numpy())


@pytest.mark.parametrize("arch", ARCHS + ["llama3-405b"])
def test_fused_prefill_equals_token_by_token_decode(arch, monkeypatch):
    """The port's fused prefill against its own token-by-token decode,
    each layer's cache entry updated in place: the same logits, caches and
    greedy tokens. The fused prefill routes all 160 tokens under one
    expert capacity and decode two tokens a step, so where the prefill's
    capacity drops assignments the two differ by design (in the reference
    too); the MoE configs run here at a capacity factor of E / K, whose
    capacity holds every token, and every MoE layer of the fused prefill
    is checked to drop none."""
    _, cfg, _, params = jax_and_port(arch)
    drops = []
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
        moe_ffn = moe.moe_ffn

        def recorded(*a, **kw):
            out, aux = moe_ffn(*a, **kw)
            drops.append(float(aux["drop_fraction"]))
            return out, aux
        monkeypatch.setattr(moe, "moe_ffn", recorded)
    toks = prompts(7)
    out = []
    for fused in (True, False):
        srv = DecodeServer(cfg, params, batch=2, max_len=MAX_LEN,
                           fused_prefill=fused)
        ids = [id(t) for entry in srv.cache for t in entry.values()]
        logits, start = srv.prefill(toks)
        if fused and cfg.moe is not None:
            assert drops and set(drops) == {0.0}
        if not fused:    # decode writes into the tensors init_cache made
            assert ids == [id(t) for e in srv.cache for t in e.values()]
        out.append((logits, srv.decode(logits, start, STEPS), srv.cache))
    (fl, ft, fc), (sl, st, sc) = out
    close(fl, sl.numpy())
    np.testing.assert_array_equal(ft, st)
    for f_l, s_l in zip(fc, sc):
        for name in f_l:
            close(f_l[name], s_l[name].numpy())


def test_params_carry_across_keeping_their_dtypes():
    """A bf16 recurrentgemma and mamba2: the float32 leaves (``lam``,
    ``A_log``, ``D``, ``dt_bias``, the router) stay float32 both ways."""
    for arch, names in (("recurrentgemma-9b", [("rglru", "lam")]),
                        ("mamba2-780m", [("ssm", "A_log"), ("ssm", "D"),
                                         ("ssm", "dt_bias")]),
                        ("mixtral-8x22b", [("ffn", "router")])):
        jcfg = jreduced_config(jget_config(arch)).replace(
            param_dtype=jnp.bfloat16)
        cfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))
        jp = JT.init_params(jax.random.key(4), jcfg)
        tree = jax.tree.map(np.asarray, jp)
        params = convert.lm_params_from_arrays(cfg, tree, "cpu")
        assert sum(p.numel() for p in params.parameters()) == \
            jcfg.param_count()
        back = convert.lm_params_to_arrays(cfg, params)
        for mod, leaf in names:
            assert params["blocks"][0][mod][leaf].dtype == torch.float32
            want = tree["blocks"]["l0"][mod][leaf]
            assert want.dtype == np.float32
            np.testing.assert_array_equal(back["blocks"]["l0"][mod][leaf],
                                          want)
        wide = [p for p in params.parameters() if p.dtype == torch.bfloat16]
        assert wide


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_the_families_reduced_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--layers", "3", "--device",
                "cpu", "--batch", "2", "--prompt-len", "40",
                "--decode-steps", "4", "--max-len", "48"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke device=cpu batch=2" in out
