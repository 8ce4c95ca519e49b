"""The vlm family of the port's LM stack against the JAX package, on the
CPU: llama-3.2-vision-11b reduced (5 layers, one pattern period of 4
self-attention layers and a gated cross-attention layer; d_model 256, 8
heads of 32 over 2 kv heads, 16 patch embeddings), the weights carried
across by ``convert.lm_params_to_arrays``.

The gates start at zero (``tanh(0) = 0``), and at zero a cross layer
adds nothing: the patches would not matter and a broken cross-attention
would pass. Every test here sets both gates of the cross layer to seeded
values in [0.3, 1), in both packages, and one shows that the served
logits then move with the patches (and do not at zero gates).

Covered: ``forward`` logits and ``lm_loss``'s value, the loss's gradient
against ``jax.value_and_grad`` (the gates' included), the fused
``prefill``'s cache (self K/V of the attention layers, the cross layer's
``ck``/``cv``), decode steps from it, the patch embeddings from key 0
(float32 within three ulps, bfloat16 bit for bit), and the port's
``DecodeServer`` against the JAX one with ``attn_impl="pallas"`` (its
flash kernel in interpret mode; the port's kernel #8 runs its plain
version on the CPU) on both prefill paths: prefill logits, greedy tokens
and caches.

Tolerances: float32 on both sides. Logits, caches and decode within rtol
1e-4 and an atol of 5e-4 times the largest magnitude compared
(tests/test_torch_models_families.py's bar); the loss within rtol 1e-6
and every gradient leaf within 1e-5 of its largest value
(tests/test_torch_lm_train.py's float32 bars); greedy
tokens equal.
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
from repro.launch.serve import DecodeServer as JServer
from repro.models import transformer as JT
from repro.models import vision as jvision
from repro_torch import convert, random
from repro_torch.launch import serve
from repro_torch.launch.serve import DecodeServer
from repro_torch.models import transformer as T
from repro_torch.models import vision
from repro_torch.utils.tree import tree_leaves, tree_map

ARCH = "llama-3.2-vision-11b"
RTOL, ATOL = 1e-4, 5e-4
PROMPT, MAX_LEN, STEPS = 40, 64, 8
GATES = ("gate_attn", "gate_ffn")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs (many small ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=RTOL, atol=ATOL * scale)


def set_gates(params, seed):
    """Both gates of every cross layer to seeded values in [0.3, 1), or
    to zero with ``seed=None``."""
    g = torch.Generator().manual_seed(seed or 0)
    for lp in params["blocks"]:
        for name in GATES:
            if name in lp:
                value = torch.rand((), generator=g) * 0.7 + 0.3
                lp[name].data.fill_(0.0 if seed is None else float(value))


@functools.lru_cache(maxsize=None)
def jax_and_port(gated=True):
    """The reduced JAX config with its flash kernel, its port, the port's
    params from a seeded generator on the CPU with the gates set (see
    ``set_gates``), and the JAX package's copy of them. (The reference's
    own ``init_params`` seeds its leaves with Python's per-process string
    hash, so its weights change from run to run.)"""
    jcfg = jreduced_config(jget_config(ARCH), vocab=512).replace(
        attn_impl="pallas")
    cfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))
    params = T.init_params(cfg, device="cpu", seed=0)
    set_gates(params, 5 if gated else None)
    jp = jax.tree.map(jnp.asarray, convert.lm_params_to_arrays(cfg, params))
    return jcfg, cfg, jp, params


def prompts(seed, n=PROMPT):
    return np.random.default_rng(seed).integers(0, 512, (2, n))


def patches(seed, cfg):
    """Seeded patch embeddings (2, 16, d_model), float32, as numpy."""
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (2, cfg.cross_attn.source_len, cfg.d_model))).astype(np.float32)


def test_config_spec_and_gates():
    jcfg, cfg, jp, params = jax_and_port()
    assert cfg.layer_kinds() == ("attn",) * 4 + ("cross",)
    assert cfg.cross_attn.source_len == 16 and cfg.max_target_positions == 0
    cross = params["blocks"][4]
    for name in GATES:
        assert cross[name].shape == () and cross[name].dtype == torch.float32
        assert 0.3 <= float(cross[name]) < 1.0
        np.testing.assert_array_equal(np.asarray(jp["blocks"]["l4"][name]),
                                      [float(cross[name])])
    assert sum(p.numel() for p in params.parameters()) == \
        jcfg.param_count() == cfg.param_count()
    fresh = T.init_params(cfg, device="cpu", seed=1)["blocks"][4]
    assert float(fresh["gate_attn"]) == float(fresh["gate_ffn"]) == 0.0


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_patch_embeddings_match_reference(dtype, jdtype):
    """The stub patches from key 0: bfloat16 bit for bit, float32 within
    three ulps of jax.random.normal's, times 0.02."""
    jcfg, cfg, _, _ = jax_and_port()
    jcfg, cfg = (jcfg.replace(compute_dtype=jdtype),
                 cfg.replace(compute_dtype=dtype))
    want = np.asarray(jvision.dummy_patch_embeddings(jax.random.key(0),
                                                     jcfg, 2))
    got = vision.dummy_patch_embeddings(random.key(0, "cpu"), cfg, 2)
    assert got.dtype == dtype and tuple(got.shape) == (2, 16, cfg.d_model)
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-7, atol=0)


def test_forward_and_loss_match_reference():
    jcfg, cfg, jp, params = jax_and_port()
    toks, x = prompts(1), patches(2, cfg)
    labels = np.roll(toks, -1, axis=1)
    jlogits, _ = JT.forward(jp, jcfg, jnp.asarray(toks, jnp.int32),
                            encoder_out=jnp.asarray(x))
    logits, aux = T.forward(params, cfg, torch.from_numpy(toks),
                            encoder_out=torch.from_numpy(x))
    close(logits, jlogits)
    assert float(aux) == 0.0
    jloss, _ = JT.lm_loss(jp, jcfg, jnp.asarray(toks, jnp.int32),
                          jnp.asarray(labels, jnp.int32),
                          encoder_out=jnp.asarray(x), seq_chunk=20)
    loss, _ = T.lm_loss(params, cfg, torch.from_numpy(toks),
                        torch.from_numpy(labels),
                        encoder_out=torch.from_numpy(x), seq_chunk=20)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_lm_loss_gradient_matches_jax_value_and_grad():
    """The loss within rtol 1e-6 and every leaf's gradient, the gates'
    and the cross-attention's included, within 1e-5 of its largest
    value (both on the ``"chunked"`` attention)."""
    jcfg, cfg, jp, params = jax_and_port()
    jcfg, cfg = (jcfg.replace(attn_impl="chunked", attn_chunk=8),
                 cfg.replace(attn_impl="chunked", attn_chunk=8))
    toks, x = prompts(3, 33), patches(4, cfg)
    tok, lab = toks[:, :-1], toks[:, 1:]
    (jl, _), jg = jax.value_and_grad(
        lambda p: JT.lm_loss(p, jcfg, jnp.asarray(tok, jnp.int32),
                             jnp.asarray(lab, jnp.int32),
                             encoder_out=jnp.asarray(x), seq_chunk=16),
        has_aux=True)(jp)
    tree = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                    params)
    loss, _ = T.lm_loss(tree, cfg, torch.from_numpy(tok),
                        torch.from_numpy(lab),
                        encoder_out=torch.from_numpy(x), seq_chunk=16)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-6)
    grads = convert.lm_params_to_arrays(cfg, tree_map(lambda p: p.grad,
                                                      tree))
    leaves = list(zip(tree_leaves(grads), jax.tree.leaves(jg)))
    assert len(leaves) == len(jax.tree.leaves(jp))
    for g, w in leaves:
        w = np.asarray(w)
        top = float(np.abs(w).max())
        assert top > 0
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * top)
    for name in GATES:
        assert abs(float(tree["blocks"][4][name].grad)) > 0


def check_cache(cfg, cache, jcache):
    """Every entry of the port's cache against the reference's (moved by
    ``convert.lm_cache_from_arrays``), and shaped as ``init_cache``'s."""
    want = convert.lm_cache_from_arrays(cfg, jax.tree.map(np.asarray,
                                                          jcache), "cpu")
    empty = T.init_cache(cfg, 2, MAX_LEN, device="cpu")
    assert len(cache) == len(want) == len(empty) == cfg.num_layers
    for kind, got_l, want_l, empty_l in zip(cfg.layer_kinds(), cache, want,
                                            empty):
        assert sorted(got_l) == sorted(want_l) == sorted(empty_l) == (
            ["ck", "cv"] if kind == "cross" else ["k", "v"])
        for name in want_l:
            assert got_l[name].shape == want_l[name].shape \
                == empty_l[name].shape
            assert got_l[name].dtype == want_l[name].dtype \
                == empty_l[name].dtype
            close(got_l[name], want_l[name].numpy())


def test_prefill_cache_and_decode_match_reference():
    jcfg, cfg, jp, params = jax_and_port()
    toks, x = prompts(5), patches(6, cfg)
    jlogits, jcache = JT.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                 MAX_LEN, encoder_out=jnp.asarray(x))
    logits, cache = T.prefill(params, cfg, torch.from_numpy(toks), MAX_LEN,
                              encoder_out=torch.from_numpy(x))
    close(logits, jlogits)
    check_cache(cfg, cache, jcache)
    tok = np.argmax(np.asarray(jlogits), axis=-1).astype(np.int32)
    for i in range(PROMPT, PROMPT + 4):
        jlogits, jcache = JT.decode_step(jp, jcfg, jnp.asarray(tok), jcache,
                                         jnp.int32(i))
        logits, cache = T.decode_step(params, cfg, torch.from_numpy(tok),
                                      cache, i)
        close(logits, jlogits)
        tok = np.argmax(np.asarray(jlogits), axis=-1).astype(np.int32)
    check_cache(cfg, cache, jcache)


@pytest.mark.parametrize("fused", [True, False])
def test_decode_server_matches_reference(fused):
    """The port's server against the JAX server, each drawing its patches
    from key 0: prefill logits, 8 greedy tokens and the caches after
    them."""
    jcfg, cfg, jp, params = jax_and_port()
    kw = dict(batch=2, max_len=MAX_LEN, fused_prefill=fused)
    toks = prompts(7)
    js = JServer(jcfg, jp, **kw)
    jlogits, start = js.prefill(toks)
    jtoks = js.decode(jlogits, start, STEPS)
    srv = DecodeServer(cfg, params, **kw)
    logits, start2 = srv.prefill(toks)
    close(logits, jlogits)
    assert start2 == start == PROMPT
    np.testing.assert_array_equal(srv.decode(logits, start2, STEPS), jtoks)
    want = convert.lm_cache_from_arrays(cfg, jax.tree.map(np.asarray,
                                                          js.cache), "cpu")
    for got_l, want_l in zip(srv.cache, want):
        for name in want_l:
            close(got_l[name], want_l[name].numpy())


@pytest.mark.parametrize("fused", [True, False])
def test_served_logits_follow_the_patches(fused, monkeypatch):
    """With the gates set, other patches (drawn from key 1) move the
    served prefill logits; at zero gates they move nothing, which is why
    every other test sets the gates."""
    real = vision.dummy_patch_embeddings
    toks = prompts(8)
    moved = {}
    for gated in (True, False):
        _, cfg, _, params = jax_and_port(gated)
        out = []
        for key in (0, 1):
            monkeypatch.setattr(serve.V, "dummy_patch_embeddings",
                                lambda k, c, b, key=key: real(
                                    random.key(key, "cpu"), c, b))
            srv = DecodeServer(cfg, params, batch=2, max_len=MAX_LEN,
                               fused_prefill=fused)
            out.append(srv.prefill(toks)[0])
        moved[gated] = float((out[0] - out[1]).abs().max())
    assert moved[True] > 1e-3
    assert moved[False] == 0.0


def test_fused_prefill_equals_token_by_token_decode():
    _, cfg, _, params = jax_and_port()
    toks = prompts(9)
    out = []
    for fused in (True, False):
        srv = DecodeServer(cfg, params, batch=2, max_len=MAX_LEN,
                           fused_prefill=fused)
        logits, start = srv.prefill(toks)
        out.append((logits, srv.decode(logits, start, STEPS), srv.cache))
    (fl, ft, fc), (sl, st, sc) = out
    close(fl, sl.numpy())
    np.testing.assert_array_equal(ft, st)
    for f_l, s_l in zip(fc, sc):
        for name in f_l:
            close(f_l[name], s_l[name].numpy())


def test_serve_cli_runs_the_vlm_reduced_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "40", "--decode-steps", "4",
                "--max-len", "48"])
    assert f"arch={ARCH}-smoke device=cpu batch=2" in capsys.readouterr().out
