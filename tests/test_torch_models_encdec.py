"""The audio family of the port's LM stack against the JAX package, on the
CPU: whisper-medium reduced (2 encoder and 2 selfcross decoder layers,
d_model 256, 4 heads of 64, 16 frames, 64 learned positions, LayerNorm,
GELU, tied embeddings), the JAX weights carried across by
``convert.lm_params_from_arrays`` (the encoder's stacked layers and the
position table too).

Covered: ``sinusoids`` and ``encoder_forward``, ``encoder_cross_kv``,
``forward`` and ``lm_loss``'s value, the loss's gradient against
``jax.value_and_grad`` (every leaf, the encoder's included), the fused
``prefill``'s cache (self K/V capped at the 64 positions and the cross
``ck``/``cv``), decode steps from that cache, and the port's
``DecodeServer`` against the JAX one on both prefill paths (prefill
logits and greedy tokens; the frames drawn from key 0 by each package's
``dummy_frame_embeddings``). One prompt of 80 tokens runs past the 64
positions: the fused prefill's self-attention then sees every prompt key
while its cache keeps the last 64 in a ring and the positions clamp, as in
the reference; the port is held to the reference's fused prefill and its
token-by-token path each.

Tolerances: float32 on both sides, differing in the order of sums and in
the ulps of exp, sin, cos and log1p. Forward logits, caches and decode
within rtol 1e-4 and an atol of 5e-4 times the largest magnitude
compared (tests/test_torch_models_families.py's bar); the loss within
rtol 1e-6 and every gradient leaf within 1e-5 of its largest value
(tests/test_torch_lm_train.py's float32 bars), or within twice the
reference's own distance from a float64 run where that is larger (never
past 1e-4; the test's docstring says where); ``sinusoids`` within
1e-7 times the length plus 1e-6 (an ulp of the frequency grows with the
position: measured 1.2e-4 at 1500 frames); greedy tokens equal.
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
from repro.models import encdec as jencdec
from repro.models import transformer as JT
from repro.models import vision as jvision
from repro_torch import convert, random
from repro_torch.launch import serve
from repro_torch.launch.serve import DecodeServer
from repro_torch.models import encdec
from repro_torch.models import transformer as T
from repro_torch.models import vision
from repro_torch.utils.tree import tree_leaves, tree_map

ARCH = "whisper-medium"
RTOL, ATOL = 1e-4, 5e-4
PROMPT, MAX_LEN, STEPS = 40, 64, 8
LONG, LONG_MAX_LEN = 80, 96      # past the 64 reduced positions


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


@functools.lru_cache(maxsize=None)
def jax_and_port(seed=0):
    """The reduced JAX config (its flash kernel where a layer takes
    ``attn_impl``: whisper has none), its port, the port's params from a
    seeded generator on the CPU and the JAX package's copy of them. (The
    reference's own ``init_params`` seeds its leaves with Python's
    per-process string hash, so its weights change from run to run.)"""
    jcfg = jreduced_config(jget_config(ARCH), vocab=512).replace(
        attn_impl="pallas")
    cfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))
    params = T.init_params(cfg, device="cpu", seed=seed)
    jp = jax.tree.map(jnp.asarray, convert.lm_params_to_arrays(cfg, params))
    return jcfg, cfg, jp, params


def prompts(seed, n=PROMPT):
    return np.random.default_rng(seed).integers(0, 512, (2, n))


def frames(seed, cfg):
    """Seeded frames (2, 16, d_model), float32, as numpy."""
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (2, cfg.encoder.source_len, cfg.d_model))).astype(np.float32)


def test_config_and_spec():
    jcfg, cfg, jp, params = jax_and_port()
    assert (cfg.num_layers, cfg.encoder.num_layers, cfg.encoder.source_len,
            cfg.max_target_positions) == (2, 2, 16, 64)
    assert cfg.layer_kinds() == ("selfcross", "selfcross")
    assert sum(p.numel() for p in params.parameters()) == \
        jcfg.param_count() == cfg.param_count()
    assert tuple(params["pos_embed"]["pos"].shape) == (64, cfg.d_model)
    assert len(params["encoder"]["blocks"]) == 2
    back = convert.lm_params_to_arrays(cfg, params)
    for got, want in zip(tree_leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("length,channels", [(16, 256), (64, 128),
                                             (1500, 1024)])
def test_sinusoids_match_reference(length, channels):
    want = np.asarray(jencdec.sinusoids(length, channels))
    got = encdec.sinusoids(length, channels).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-7 * length + 1e-6)


def test_encoder_forward_and_cross_kv_match_reference():
    jcfg, cfg, jp, params = jax_and_port()
    x = frames(1, cfg)
    want = jencdec.encoder_forward(jp["encoder"], jcfg, jnp.asarray(x))
    got = encdec.encoder_forward(params["encoder"], cfg, torch.from_numpy(x))
    close(got, want)
    jck, jcv, jenc = jencdec.encoder_cross_kv(jp, jcfg, jnp.asarray(x))
    ck, cv, enc = encdec.encoder_cross_kv(params, cfg, torch.from_numpy(x))
    close(enc, jenc)
    close(ck, jck)
    close(cv, jcv)


def test_frame_embeddings_match_reference():
    """The stub frames from key 0: float32 draws within three ulps of
    jax.random.normal's, times 0.02."""
    jcfg, cfg, _, _ = jax_and_port()
    want = np.asarray(jvision.dummy_frame_embeddings(jax.random.key(0),
                                                     jcfg, 2))
    got = vision.dummy_frame_embeddings(random.key(0, "cpu"), cfg, 2)
    assert tuple(got.shape) == want.shape == (2, 16, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-7, atol=0)


def test_forward_and_loss_match_reference():
    jcfg, cfg, jp, params = jax_and_port()
    toks, x = prompts(1), frames(2, cfg)
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


def port_grads(params, cfg, tok, lab, x, dtype):
    """The port's loss and its gradient (as float64 arrays in the
    reference's layout) with the weights, the frames and the compute in
    ``dtype``."""
    tree = tree_map(lambda p: p.detach().to(dtype).requires_grad_(True),
                    params)
    loss, _ = T.lm_loss(tree, cfg.replace(attn_impl="chunked",
                                          compute_dtype=dtype),
                        torch.from_numpy(tok), torch.from_numpy(lab),
                        encoder_out=torch.from_numpy(x).to(dtype),
                        seq_chunk=16)
    loss.backward()
    return float(loss.detach()), convert.lm_params_to_arrays(
        cfg, tree_map(lambda p: p.grad.double(), tree))


def test_lm_loss_gradient_matches_jax_value_and_grad():
    """The loss within rtol 1e-6 and every leaf's gradient (the
    encoder's, the position table's and the cross-attention's included)
    within 1e-5 of its largest value, or within twice the reference's own
    distance from the float64 gradient where that is larger: float32
    rounding moves the gradients of the cross-attention's ``wq``/``wk``
    and of ``lnx`` by up to 3.1e-5 of their largest value in the
    reference itself (measured against the port run in float64; the
    port's float32 run is 4.9e-5 from it)."""
    jcfg, cfg, jp, params = jax_and_port()
    toks, x = prompts(3, 33), frames(4, cfg)
    tok, lab = toks[:, :-1], toks[:, 1:]
    (jl, _), jg = jax.value_and_grad(
        lambda p: JT.lm_loss(p, jcfg, jnp.asarray(tok, jnp.int32),
                             jnp.asarray(lab, jnp.int32),
                             encoder_out=jnp.asarray(x), seq_chunk=16),
        has_aux=True)(jp)
    loss, grads = port_grads(params, cfg, tok, lab, x, torch.float32)
    _, exact = port_grads(params, cfg, tok, lab, x, torch.float64)
    assert loss == pytest.approx(float(jl), rel=1e-6)
    leaves = list(zip(tree_leaves(grads), jax.tree.leaves(jg),
                      tree_leaves(exact)))
    assert len(leaves) == len(jax.tree.leaves(jp))
    for g, w, e in leaves:
        w = np.asarray(w, np.float64)
        top = float(np.abs(w).max())
        assert top > 0
        tol = max(1e-5 * top, 2 * float(np.abs(w - e).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
        assert float(np.abs(g - w).max()) <= 1e-4 * top


def check_cache(cfg, cache, jcache, batch, max_len):
    """Every entry of the port's cache against the reference's (moved by
    ``convert.lm_cache_from_arrays``), and shaped as ``init_cache``'s."""
    want = convert.lm_cache_from_arrays(cfg, jax.tree.map(np.asarray,
                                                          jcache), "cpu")
    empty = T.init_cache(cfg, batch, max_len, device="cpu")
    assert len(cache) == len(want) == len(empty) == cfg.num_layers
    for got_l, want_l, empty_l in zip(cache, want, empty):
        assert sorted(got_l) == sorted(want_l) == sorted(empty_l) == [
            "ck", "cv", "k", "v"]
        for name in want_l:
            assert got_l[name].shape == want_l[name].shape \
                == empty_l[name].shape
            assert got_l[name].dtype == want_l[name].dtype \
                == empty_l[name].dtype
            close(got_l[name], want_l[name].numpy())


@pytest.mark.parametrize("n,max_len", [(PROMPT, MAX_LEN),
                                       (LONG, LONG_MAX_LEN)])
def test_prefill_cache_and_decode_match_reference(n, max_len):
    """The fused prefill (self K/V in min(max_len, 64) slots, a ring the
    80-token prompt wraps) and four decode steps after it."""
    jcfg, cfg, jp, params = jax_and_port()
    toks, x = prompts(5, n), frames(6, cfg)
    jlogits, jcache = JT.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                 max_len, encoder_out=jnp.asarray(x))
    logits, cache = T.prefill(params, cfg, torch.from_numpy(toks), max_len,
                              encoder_out=torch.from_numpy(x))
    close(logits, jlogits)
    assert cache[0]["k"].shape[1] == min(max_len, 64)
    check_cache(cfg, cache, jcache, 2, max_len)
    tok = np.argmax(np.asarray(jlogits), axis=-1).astype(np.int32)
    for i in range(n, n + 4):
        jlogits, jcache = JT.decode_step(jp, jcfg, jnp.asarray(tok), jcache,
                                         jnp.int32(i))
        logits, cache = T.decode_step(params, cfg, torch.from_numpy(tok),
                                      cache, i)
        close(logits, jlogits)
        tok = np.argmax(np.asarray(jlogits), axis=-1).astype(np.int32)
    check_cache(cfg, cache, jcache, 2, max_len)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("n,max_len", [(PROMPT, MAX_LEN),
                                       (LONG, LONG_MAX_LEN)])
def test_decode_server_matches_reference(fused, n, max_len):
    """The port's server against the JAX server, each drawing its frames
    from key 0: prefill logits, 8 greedy tokens and the caches after
    them. At 80 tokens the two prefill paths of each package disagree
    (the finding above), and each port path equals its reference path."""
    jcfg, cfg, jp, params = jax_and_port()
    kw = dict(batch=2, max_len=max_len, fused_prefill=fused)
    toks = prompts(7, n)
    js = JServer(jcfg, jp, **kw)
    jlogits, start = js.prefill(toks)
    jtoks = js.decode(jlogits, start, STEPS)
    srv = DecodeServer(cfg, params, **kw)
    logits, start2 = srv.prefill(toks)
    close(logits, jlogits)
    assert start2 == start == n
    np.testing.assert_array_equal(srv.decode(logits, start2, STEPS), jtoks)
    want = convert.lm_cache_from_arrays(cfg, jax.tree.map(np.asarray,
                                                          js.cache), "cpu")
    for got_l, want_l in zip(srv.cache, want):
        for name in want_l:
            close(got_l[name], want_l[name].numpy())


def test_fused_prefill_equals_token_by_token_within_the_positions():
    """Within the 64 positions the port's fused prefill equals its own
    token-by-token path; past them the two part, as the reference's do."""
    _, cfg, _, params = jax_and_port()
    out = {}
    for n, max_len in ((PROMPT, MAX_LEN), (LONG, LONG_MAX_LEN)):
        for fused in (True, False):
            srv = DecodeServer(cfg, params, batch=2, max_len=max_len,
                               fused_prefill=fused)
            out[n, fused] = srv.prefill(prompts(8, n))[0]
    close(out[PROMPT, True], out[PROMPT, False].numpy())
    gap = float((out[LONG, True] - out[LONG, False]).abs().max())
    assert gap > 1e-2


def test_serve_cli_runs_whisper_reduced_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "40", "--decode-steps", "4",
                "--max-len", "48"])
    assert f"arch={ARCH}-smoke device=cpu batch=2" in capsys.readouterr().out
