"""The ssm, hybrid, audio and vlm families on a mesh (``launch/specs.py``'s
step builders on DTensors) against the JAX package's single-device
functions.

The ranks run in the families' own spawned 2- and 4-rank ``gloo`` groups
(``tests/torch_mesh_cases.py::family_ranks``, which imports no JAX,
started with the other groups and beside them), on reduced
mamba2-780m, recurrentgemma-9b, whisper-medium and llama-3.2-vision-11b
(``reduced_config`` at d_model 256, vocab 1024, float32; the vision
model's cross-layer gates seeded in [0.3, 1), where a cross layer does
something), on (1, 2), (2, 2) and (1, 4) meshes; the JAX side runs here
on the same seeded weights, moved by ``convert.lm_params_to_arrays``,
with its plain attention:

- whisper's ``encoder_cross_kv`` on the mesh (the stacked cross K/V and
  the encoder's output) within 2e-5 of each one's largest value;
- ``build_prefill_step``'s logits, and ``build_decode_step``'s for
  LM_STEPS greedy steps (profile ``context``; ``batch`` too on (2, 2))
  on the cache of the fused prefill: within 2e-5 of the largest |logit|
  of ``JT.forward(last_only=True)``, ``JT.prefill`` and ``JT.decode_step``
  fed the same tokens (the greedy tokens equal); every cache leaf after
  the steps (the SSD and RG-LRU states, the conv windows, the self and
  cross K/V) within 2e-5 of its largest value;
- one all-reduce SGD ``build_train_step`` step at step 50 (learning rate
  1.5e-4): the loss at rtol 1e-6 and every parameter within 1e-6 of its
  leaf's largest value, against the jitted ``make_allreduce_train_step``,
  but for the leaves that start at zero (biases, ``A_log``, ``dt_bias``):
  after one step such a leaf is the step itself, so the comparison reads
  its gradient, held to the family's ``LOW_RTOL`` of its largest value
  (the float32 gradients of two programs that sum in other orders;
  ``tests/test_torch_models_encdec.py`` holds whisper's to 1e-5 on one
  device). Every rank's parameters equal rank 0's bit for bit;
- mamba2 at bfloat16 compute on (1, 2) against the port's own
  one-process bfloat16 run (``BF16_TOL``, layer 0's states
  ``LAYER0_TOL``), the greedy tokens near-max ones.

Each case asserts its placements (the mixers' projections sharded over
``model`` as the rules say at these widths, their small leaves whole)
and kernel #8's local shapes on the hybrid's local layer (16 query heads
of 16 over ``model``, the one kv head replicated) and the vision model's
self-attention layers.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jget_config
from repro.config import reduced_config as jreduced_config
from repro.core import gossip_optimizer as jgo
from repro.models import encdec as jencdec
from repro.models import transformer as JT
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch import convert
from repro_torch.models import transformer as T
from repro_torch.utils.tree import tree_map
from torch_mesh_cases import (BF16_MESH, FAMILY_ARCHS, FAMILY_MESHES,
                              LM_BATCH,
                              LM_CACHE, LM_PROMPT, LM_STEPS, LM_TRAIN_STEP,
                              family_config, family_params, family_source,
                              lm_tokens, shared_ranks)

LOGIT_TOL = 2e-5        # of the largest |logit| (test_torch_mesh_lm.py's)
PARAM_TOL = 1e-6        # of each leaf's largest value
# a zero-initialized leaf after one step, by family: about twice the
# largest gap measured over the three meshes (mamba2 6.8e-6,
# recurrentgemma 3.5e-6, whisper 1.08e-5 on its lnx biases, vision 0;
# the other leaves within 4e-8), and PARAM_TOL where none was seen
LOW_RTOL = {"mamba2-780m": 1.5e-5, "recurrentgemma-9b": 7e-6,
            "whisper-medium": 2.5e-5, "llama-3.2-vision-11b": 1e-6}
LOSS_RTOL = 1e-6
# mamba2 at bfloat16 compute on a mesh against one process at bfloat16:
# of the largest value (measured at most 1.7e-2; the one-process run moves
# its logits 1.4e-2 between bfloat16 and float32 compute), and layer 0's
# states (measured at most 2.2e-8)
BF16_TOL = 3e-2
LAYER0_TOL = 1e-5
CASES = [(w, m, a) for w, meshes in FAMILY_MESHES.items() for m in meshes
         for a in FAMILY_ARCHS]
IDS = [f"{m}-{a}" for _, m, a in CASES]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return {w: shared_ranks(tmp_path_factory, f"families{w}")
            for w in FAMILY_MESHES}


def jax_config(arch, train=False):
    jcfg = jreduced_config(jget_config(arch), d_model=256, vocab=1024)
    if train:
        return jcfg.replace(attn_impl="chunked", attn_chunk=16,
                            xent_chunk=16)
    return jcfg.replace(attn_impl="xla")


@functools.lru_cache(maxsize=None)
def jax_serve(arch):
    """The JAX package's prefill logits, fused prefill, and decode steps
    greedy from its own first logits, on the cases' weights."""
    cfg, jcfg = family_config(arch), jax_config(arch)
    jp = jax.tree.map(jnp.asarray, convert.lm_params_to_arrays(
        cfg, family_params(cfg, 7)))
    toks = jnp.asarray(lm_tokens(3, (LM_BATCH, LM_PROMPT), cfg.vocab_size))
    src = family_source(cfg, LM_BATCH, 4)
    enc = None if src is None else jnp.asarray(src)
    want, _ = JT.forward(jp, jcfg, toks, encoder_out=enc, last_only=True)
    first, cache = JT.prefill(jp, jcfg, toks, LM_CACHE, encoder_out=enc)
    steps, lg = [], first
    for i in range(LM_STEPS):
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        lg, cache = JT.decode_step(jp, jcfg, tok, cache,
                                   jnp.int32(LM_PROMPT + i))
        steps.append(np.asarray(lg))
    return (np.asarray(want), np.asarray(first), steps,
            jax.tree.map(np.asarray, cache))


@functools.lru_cache(maxsize=None)
def jax_cross_kv():
    """whisper's ``encoder_cross_kv`` in the JAX package on the cases'
    weights and frames: the stacked ck, cv and the encoder's output."""
    cfg, jcfg = family_config("whisper-medium"), jax_config("whisper-medium")
    jp = jax.tree.map(jnp.asarray, convert.lm_params_to_arrays(
        cfg, family_params(cfg, 7)))
    src = jnp.asarray(family_source(cfg, LM_BATCH, 4))
    return [np.asarray(a) for a in jencdec.encoder_cross_kv(jp, jcfg, src)]


@functools.lru_cache(maxsize=None)
def jax_train(arch):
    cfg, jcfg = family_config(arch, True), jax_config(arch, True)
    jp = jax.tree.map(jnp.asarray, convert.lm_params_to_arrays(
        cfg, family_params(cfg, 20)))
    opt = jmake_optimizer("sgd", jwarmup_cosine(3e-4, 100, 10_000))

    def loss_fn(p, b):
        return JT.lm_loss(p, jcfg, b["tokens"], b["labels"],
                          encoder_out=b.get("encoder_out"))
    fn = jax.jit(jgo.make_allreduce_train_step(loss_fn, opt))
    toks = lm_tokens(30, (4, 33), cfg.vocab_size)
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])}
    src = family_source(cfg, 4, 8)
    if src is not None:
        batch["encoder_out"] = jnp.asarray(src)
    new, _, loss, _ = fn(jp, opt.init(jp), batch, jnp.int32(LM_TRAIN_STEP))
    zero = jax.tree.map(lambda a: not np.asarray(a).any(), jp)
    return new, float(loss), zero


def close(got, want, frac, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    top = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * top,
                               err_msg=what)
    return float(np.abs(got - want).max()) / max(top, 1e-30)


def reference_layout(cfg, tree, cache=False):
    """A rank's parameters (or a cache: a list of per-layer dicts) of
    arrays in the reference's stacked layout."""
    tree = tree_map(torch.from_numpy, tree)
    return tree_map(lambda t: t.numpy(), convert.lm_params_to_reference(
        cfg, {"blocks": tree} if cache else tree))


def case_of(groups, world, mesh, arch):
    return [r[mesh][arch] for r in groups[world]]


def mesh_sizes(mesh):
    shape, _ = FAMILY_MESHES[{"tp": 2}.get(mesh, 4)][mesh]
    return shape


@pytest.mark.parametrize("world,mesh,arch", CASES, ids=IDS)
def test_prefill_and_decode_match_jax(groups, world, mesh, arch):
    cfg = family_config(arch)
    want, first, steps, cache = jax_serve(arch)
    ranks = case_of(groups, world, mesh, arch)
    gaps = {}
    if arch == "whisper-medium":
        kv = jax_cross_kv()
        for r in ranks:
            gaps["cross_kv"] = max(close(g, w, LOGIT_TOL, "encoder_cross_kv")
                                   for g, w in zip(r["cross_kv"], kv))
    for r in ranks:
        gaps["prefill"] = close(r["prefill"], want, LOGIT_TOL, "prefill")
        for profile, d in r["decode"].items():
            g = [close(d["first"], first, LOGIT_TOL, f"{profile} first")]
            for i, (s, w) in enumerate(zip(d["steps"], steps)):
                assert (np.argmax(s, -1) == np.argmax(w, -1)).all()
                g.append(close(s, w, LOGIT_TOL, f"{profile} step {i}"))
            got = reference_layout(cfg, d["cache"], cache=True)
            assert jax.tree.structure(got) == jax.tree.structure(cache)
            for (path, w), g_ in zip(jax.tree.leaves_with_path(cache),
                                     jax.tree.leaves(got)):
                g.append(close(g_, w, LOGIT_TOL, f"{profile} cache "
                               f"{jax.tree_util.keystr(path)}"))
            gaps[profile] = max(g)
    print(mesh, arch, "gaps", gaps)       # read with -s


@pytest.mark.parametrize("world,mesh,arch", CASES, ids=IDS)
def test_train_step_matches_jax(groups, world, mesh, arch):
    cfg = family_config(arch, True)
    new, loss, zero = jax_train(arch)
    ranks = case_of(groups, world, mesh, arch)
    t0 = ranks[0]["train"]
    for r in ranks:
        assert r["train"]["loss"] == pytest.approx(loss, rel=LOSS_RTOL)
        assert r["train"]["digest"] == t0["digest"]
    got = reference_layout(cfg, t0["params"])
    assert jax.tree.structure(got) == jax.tree.structure(new)
    gap, low = 0.0, 0.0
    for g, w, z in zip(jax.tree.leaves(got), jax.tree.leaves(new),
                       jax.tree.leaves(zero)):
        if z:
            low = max(low, close(g, w, LOW_RTOL[arch],
                                 "zero-initialized leaf"))
        else:
            gap = max(gap, close(g, w, PARAM_TOL, "params"))
    print(mesh, arch, "gap", gap, "zero-initialized leaves", low)


def test_placements_and_local_kernel_shapes(groups):
    for world, mesh, arch in CASES:
        dp, mp = mesh_sizes(mesh)
        r = case_of(groups, world, mesh, arch)[0]
        pl = r["params_pl"]
        fsdp = "S(0)" if dp > 1 else "R"
        big = {"mamba2-780m": ("0/ssm/w_in", "0/ssm/w_in"),
               "recurrentgemma-9b": ("0/rglru/w_x", "0/rglru/w_y"),
               "whisper-medium": ("0/attn/wq", "0/cross_attn/wq"),
               "llama-3.2-vision-11b": ("0/attn/wq", "0/ffn/w_up")}[arch]
        for leaf in big:
            assert pl[f"blocks/{leaf}"] == [fsdp, "S(1)"], (mesh, leaf)
        small = {"mamba2-780m": ("A_log", "D", "dt_bias", "conv_w"),
                 "recurrentgemma-9b": ("w_a", "b_a", "lam", "conv_w")}
        for leaf in small.get(arch, ()):
            kind = "ssm" if arch.startswith("mamba") else "rglru"
            assert pl[f"blocks/0/{kind}/{leaf}"] == ["R", "R"], leaf
        if arch == "whisper-medium":
            assert pl["encoder/blocks/0/attn/wq"] == [fsdp, "S(1)"]
        a = family_config(arch).attention
        n_flash = sum(k in ("attn", "local")
                      for k in family_config(arch).layer_kinds())
        if arch in ("mamba2-780m", "whisper-medium"):
            assert r["flash"] == []             # #8 is not on their path
            continue
        kl = a.num_kv_heads // mp if a.num_kv_heads % mp == 0 else 1
        q = (LM_BATCH // dp, LM_PROMPT, a.num_heads // mp, a.head_dim)
        assert r["flash"] == [(q, q[:2] + (kl, a.head_dim))] * n_flash
    # the recurrent states where the cache rules put them on (2, 2): the
    # width over model, the batch over data ("batch") or the width over
    # data and the batch over model ("context": its longest dim first)
    d = case_of(groups, 4, "tp2x2", "recurrentgemma-9b")[0]["decode"]
    assert d["batch"]["cache_pl"]["0/h"] == ["S(0)", "S(1)"]
    assert d["context"]["cache_pl"]["0/h"] == ["S(1)", "S(0)"]
    assert d["context"]["cache_pl"]["0/conv"] == ["S(2)", "S(0)"]
    d = case_of(groups, 4, "tp2x2", "mamba2-780m")[0]["decode"]
    assert d["context"]["cache_pl"]["0/ssm"] == ["S(2)", "R"]


def test_ssm_bf16_matches_one_process(groups):
    """mamba2 at bfloat16 compute on (1, 2) against the port's one-process
    bfloat16 run, fed the mesh's greedy tokens: the logits within
    BF16_TOL of the largest |logit|, each greedy token within BF16_TOL of
    the one-process run's top logit, the states within BF16_TOL of each
    leaf's largest value, layer 0's (the first layer's casts and slices,
    before any sum over the ranks reaches the stream) within LAYER0_TOL."""
    cfg = family_config("mamba2-780m", bf16=True)
    params = family_params(cfg, 7)
    toks = torch.from_numpy(lm_tokens(3, (LM_BATCH, LM_PROMPT),
                                      cfg.vocab_size))
    for r in groups[2]:
        r, gaps = r["bf16"], {}
        assert r["params_pl"]["blocks/0/ssm/w_in"] == ["R", "S(1)"]
        d = r["decode"]["context"]
        with torch.no_grad():
            want, _ = T.forward(params, cfg, toks, last_only=True)
            first, cache = T.prefill(params, cfg, toks, LM_CACHE)
            got, wants = [d["first"]] + d["steps"], [first]
            for i, prev in enumerate(got[:-1]):
                tok = torch.from_numpy(np.argmax(prev, -1).astype(np.int32))
                lg, cache = T.decode_step(params, cfg, tok, cache,
                                          LM_PROMPT + i)
                wants.append(lg)
        gaps["prefill"] = close(r["prefill"], want, BF16_TOL, "prefill")
        for i, (g, w) in enumerate(zip(got, wants)):
            w = w.float().numpy()
            gaps[f"logits {i}"] = close(g, w, BF16_TOL, f"logits {i}")
            pick = np.take_along_axis(w, np.argmax(g, -1)[:, None], -1)
            assert (w.max(-1) - pick[:, 0] <= BF16_TOL * np.abs(w).max()
                    ).all(), f"greedy token {i}"
        for layer, (g, w) in enumerate(zip(d["cache"], cache)):
            for name in w:
                bar = LAYER0_TOL if layer == 0 else BF16_TOL
                gaps[f"{layer}/{name}"] = close(
                    g[name], w[name].float().numpy(), bar,
                    f"layer {layer}'s {name}")
        print("bf16 gaps", gaps)          # read with -s
