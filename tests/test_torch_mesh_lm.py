"""The LM on a mesh (``launch/specs.py``'s step builders on DTensors)
against the JAX package's single-device functions.

The ranks run in the spawned 2- and 4-rank ``gloo`` groups that
``test_torch_mesh_engine.py`` and ``test_torch_mesh_gossip.py`` share
(``tests/torch_mesh_cases.py::lm_ranks``, which imports no JAX); the JAX
side runs here on the same seeded weights, moved by
``convert.lm_params_to_arrays``. Every case runs in float32:

- ``build_prefill_step``'s logits and ``build_decode_step``'s (profiles
  ``context`` and ``batch``, the cache filled by the fused prefill) on a
  (1, 2) tensor-parallel mesh, a (2, 2) mesh, and a (1, 4) mesh where the
  rules replicate the 2 kv heads and split the 8 query heads (each rank's
  kernel #8 call takes the one kv head its two query heads read): within
  2e-5 of the largest |logit| of ``JT.forward(last_only=True)``,
  ``JT.prefill`` and ``JT.decode_step`` fed the same tokens; the cache
  after the steps within 2e-5 of its largest value, on a (2, 1) mesh
  with its length sharded over ``data`` too;
- the MoE's reduce combine and gather combine ('tensor' sharding, G = 2
  over ``data``) on (2, 2) against each other and ``moe_ffn`` on one
  device: outputs within 2e-5 of the largest value, the aux losses at
  rtol 1e-6, every rank's call counted in its combine;
- one ``build_train_step`` step at step 50 (learning rate 1.5e-4),
  all-reduce (FSDP over ``data`` on (2, 1); SGD and AdamW) and gossip
  (mu, int8, SGD; the peers on ``data``, each tensor parallel over
  ``model`` on (2, 2)), against the jitted single-device
  ``make_allreduce_train_step`` and the stacked gossip steps: the loss at
  rtol 1e-6 and every parameter within 1e-6 of its leaf's largest value,
  with two stated exceptions. AdamW's first step divides each gradient
  element by its own magnitude, so an element that nearly cancels moves
  with the shards' sum order: at most 1e-4 of a leaf beyond 1e-6, all
  within 1e-5. Against the reference's jitted gossip step, XLA's fused
  int8 encode rounds a few codes of the merge the other way (the
  allowance of ``tests/test_torch_lm_train.py``'s int8 case: at most 1 %
  of a leaf beyond 1e-6, all within 1e-2); against the port's stacked
  step every parameter is within 1e-6.

Each case asserts the placements of its weights and of one activation
(kernel #8's local shapes, the logits or the MoE output): sharded where
the rules say."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import GossipConfig as JGossipConfig
from repro.config import get_config as jget_config
from repro.config import reduced_config as jreduced_config
from repro.core import gossip_optimizer as jgo
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch import convert
from repro_torch.config import GossipConfig
from repro_torch.core import gossip_optimizer as go
from repro_torch.launch import specs
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.utils.tree import tree_leaves, tree_map
from torch_mesh_cases import (LM_BATCH, LM_CACHE, LM_PROMPT, LM_STEPS,
                              LM_TRAIN_STEP, lm_config, lm_tokens,
                              shared_ranks)

LOGIT_TOL = 2e-5        # of the largest |logit|
PARAM_TOL = 1e-6        # of each leaf's largest value (the peer mesh's bar)
LOSS_RTOL = 1e-6


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return [r["lm"] for r in shared_ranks(tmp_path_factory, 2)]


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return [r["lm"] for r in shared_ranks(tmp_path_factory, 4)]


def jax_config(kind):
    """The JAX side of ``lm_config``: the same mechanical reduction and
    replacements, run in the plain grouped attention."""
    if kind == "moe":
        return jreduced_config(jget_config("mixtral-8x22b"), d_model=128,
                               layers=2, vocab=512).replace(attn_impl="xla")
    jcfg = jreduced_config(jget_config("qwen3-1.7b"), d_model=256, layers=2,
                           vocab=1024)
    jcfg = jcfg.replace(attention=dataclasses.replace(
        jcfg.attention, num_heads=8, num_kv_heads=2 if kind == "kv2" else 4,
        head_dim=64))
    if kind == "train":
        return jcfg.replace(attn_impl="chunked", attn_chunk=16,
                            xent_chunk=16)
    return jcfg.replace(attn_impl="xla")


def jax_params(cfg, seed):
    return jax.tree.map(jnp.asarray, convert.lm_params_to_arrays(
        cfg, T.init_params(cfg, device="cpu", seed=seed)))


def close(got, want, frac, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    top = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * top,
                               err_msg=what)
    return float(np.abs(got - want).max()) / max(top, 1e-30)


def stacked_cache(cfg, cache):
    """A rank's cache (a list of per-layer dicts of arrays) in the
    reference's stacked layout."""
    return tree_map(lambda t: t.numpy(), convert.lm_params_to_reference(
        cfg, {"blocks": tree_map(torch.from_numpy, cache)}))


def check_serve(ranks, kind, profiles):
    """Every rank's prefill and decode against the JAX functions; returns
    the largest gap of each quantity, relative to its largest value."""
    cfg, jcfg = lm_config(kind), jax_config(kind)
    jp = jax_params(cfg, 7)
    toks = jnp.asarray(lm_tokens(3, (LM_BATCH, LM_PROMPT), cfg.vocab_size))
    want, _ = JT.forward(jp, jcfg, toks, last_only=True)
    gaps = {"prefill": 0.0}
    for r in ranks:
        gaps["prefill"] = max(gaps["prefill"], close(
            r["prefill"], want, LOGIT_TOL, "prefill"))
    for profile in profiles:
        run = ranks[0]["decode"][profile]
        first, cache = JT.prefill(jp, jcfg, toks, LM_CACHE)
        feed = [np.argmax(run["first"], -1)] + [
            np.argmax(s, -1) for s in run["steps"][:-1]]
        wants = []
        for i in range(LM_STEPS):
            assert (feed[i] == np.argmax(
                np.asarray(first if i == 0 else wants[-1]), -1)).all()
            lg, cache = JT.decode_step(jp, jcfg, jnp.asarray(
                feed[i], jnp.int32), cache, jnp.int32(LM_PROMPT + i))
            wants.append(lg)
        for r in ranks:
            d = r["decode"][profile]
            g = [close(d["first"], first, LOGIT_TOL, f"{profile} first")]
            g += [close(s, w, LOGIT_TOL, f"{profile} step {i}")
                  for i, (s, w) in enumerate(zip(d["steps"], wants))]
            got = stacked_cache(cfg, d["cache"])
            for p in ("k", "v"):
                g.append(close(got["blocks"]["l0"][p],
                               cache["blocks"]["l0"][p], LOGIT_TOL,
                               f"{profile} cache {p}"))
            gaps[profile] = max([gaps.get(profile, 0.0)] + g)
    return gaps


def test_tensor_parallel_prefill_and_decode_match_jax(two):
    gaps = check_serve([r["tp"] for r in two], "dense", ("context", "batch"))
    print("gaps", gaps)
    r = two[0]["tp"]
    # 8 query heads and 4 kv heads over model = 2: 4 and 2 on each rank
    assert r["flash"] == [((2, 32, 4, 64), (2, 32, 2, 64))] * 2
    assert r["params_pl"]["blocks/0/attn/wq"] == ["R", "S(1)"]
    assert r["params_pl"]["blocks/0/ffn/w_down"] == ["R", "S(0)"]
    assert r["params_pl"]["embed/table"] == ["R", "S(0)"]
    assert r["logits_pl"][1] == "S(1)"              # vocab over model


def test_length_sharded_decode_cache_equals_the_one_device_cache(two):
    gaps = check_serve([r["length"] for r in two], "dense", ("context",))
    print("gaps", gaps)
    r = two[0]["length"]
    # the cache's length over data: each rank writes the slots it holds
    assert r["decode"]["context"]["cache_pl"]["0/k"] == ["S(1)", "R"]
    assert r["params_pl"]["blocks/0/attn/wq"] == ["S(0)", "R"]   # FSDP
    assert r["flash"] == [((1, 32, 8, 64), (1, 32, 4, 64))] * 2   # batch


def test_2x2_prefill_and_decode_match_jax(four):
    gaps = check_serve([r["tp2x2"] for r in four], "dense",
                       ("context", "batch"))
    print("gaps", gaps)
    r = four[0]["tp2x2"]
    assert r["flash"] == [((1, 32, 4, 64), (1, 32, 2, 64))] * 2
    assert r["params_pl"]["blocks/0/attn/wq"] == ["S(0)", "S(1)"]
    assert r["decode"]["context"]["cache_pl"]["0/k"] == ["S(1)", "R"]
    assert r["decode"]["batch"]["cache_pl"]["0/k"] == ["R", "S(0)"]


def test_replicated_kv_heads_take_their_query_heads_kv(four):
    gaps = check_serve([r["kv2"] for r in four], "kv2", ("context",))
    print("gaps", gaps)
    r = four[0]["kv2"]
    # 8 query heads over 4 ranks read 1 of the 2 replicated kv heads each
    assert r["flash"] == [((2, 32, 2, 64), (2, 32, 1, 64))] * 2
    assert r["params_pl"]["blocks/0/attn/wq"] == ["R", "S(1)"]
    assert r["params_pl"]["blocks/0/attn/wk"] == ["R", "R"]


def test_moe_reduce_combine_matches_gather_and_jax(four):
    cfg = lm_config("moe")
    x = np.random.default_rng(4).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    gaps = {}
    for combine in ("reduce", "gather"):
        m = dataclasses.replace(cfg.moe, dispatch_groups=2, combine=combine)
        spec = moe.moe_spec(cfg.d_model, m, cfg.act)
        params = L.init_params(spec, torch.Generator().manual_seed(5), "cpu")
        jp = {k: jnp.asarray(v.detach().numpy())
              for k, v in params.named_parameters()}
        jm = dataclasses.replace(jax_config("moe").moe, dispatch_groups=2)
        want, jaux = jmoe.moe_ffn(jp, jm, jnp.asarray(x), cfg.act)
        for r in four:
            got = r["moe"][combine]
            gaps[combine] = close(got["y"], want, LOGIT_TOL, combine)
            for k in ("load_balance_loss", "drop_fraction"):
                assert float(got["aux"][k]) == pytest.approx(
                    float(jaux[k]), rel=LOSS_RTOL, abs=1e-12), k
            assert got["counts"] == {"reduce": int(combine == "reduce"),
                                     "gather": int(combine == "gather")}
            assert got["params_pl"]["w_up"] == ["S(1)", "S(2)"]
            assert got["y_pl"] == ["S(0)", "R"]
    for r in four:
        close(r["moe"]["reduce"]["y"], r["moe"]["gather"]["y"], LOGIT_TOL,
              "reduce vs gather")
    print("gaps", gaps)


def _jax_batch(toks):
    return {"tokens": jnp.asarray(toks[..., :-1]),
            "labels": jnp.asarray(toks[..., 1:])}


def _loss_fn(jcfg):
    return lambda p, b: JT.lm_loss(p, jcfg, b["tokens"], b["labels"])


# AdamW's first step divides each gradient element by its own magnitude,
# so where an element nearly cancels, the shards' sum order moves its
# update by up to ~1e-2 of the learning rate: measured 20 elements a rank
# past 1e-6 of their leaf's largest value, the farthest at 6.1e-6
ADAM_BEYOND, ADAM_FAR = 1e-4, 1e-5


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_allreduce_train_step_matches_jax(two, optimizer):
    cfg, jcfg = lm_config("train"), jax_config("train")
    jp = jax_params(cfg, 20)
    opt = jmake_optimizer(optimizer, jwarmup_cosine(3e-4, 100, 10_000))
    fn = jax.jit(jgo.make_allreduce_train_step(_loss_fn(jcfg), opt))
    toks = lm_tokens(30, (4, 33), cfg.vocab_size)
    new, _, loss, _ = fn(jp, opt.init(jp), _jax_batch(toks),
                         jnp.int32(LM_TRAIN_STEP))
    gap, beyond = 0.0, 0
    for r in two:
        t = r["train_allreduce"][optimizer]
        assert t["step"] == LM_TRAIN_STEP + 1
        assert t["loss"] == pytest.approx(float(loss), rel=LOSS_RTOL)
        got = convert.lm_params_to_reference(cfg, tree_map(
            torch.from_numpy, t["params"]))
        for g, w in zip(tree_leaves(got), jax.tree.leaves(new)):
            g, w = g.numpy(), np.asarray(w)
            top = np.abs(w).max()
            if optimizer == "adamw":
                off = np.abs(g - w) > PARAM_TOL * top
                assert off.mean() <= ADAM_BEYOND
                beyond += int(off.sum())
                gap = max(gap, close(g, w, ADAM_FAR, "params"))
            else:
                gap = max(gap, close(g, w, PARAM_TOL, "params"))
        assert t["params_pl"]["blocks/0/ffn/w_up"] == ["S(0)", "R"]  # FSDP
    print("gap", gap, "beyond 1e-6", beyond)


def test_gossip_train_step_matches_the_stacked_steps(four):
    cfg, jcfg = lm_config("train"), jax_config("train")
    peers = 2
    # the port's stacked step (one process, the peers on a leading dim)
    tp = [T.init_params(cfg, device="cpu", seed=20 + p) for p in range(peers)]
    tstack = tree_map(lambda *xs: torch.stack([x.detach() for x in xs]),
                      *tp)
    topt = make_optimizer("sgd", warmup_cosine(3e-4, 100, 10_000))
    tcfg = GossipConfig(merge="mu", exchange_dtype="int8")
    tfn = go.make_gossip_train_step(specs.make_loss_fn(cfg), topt, peers,
                                    tcfg)
    perm, _ = go.perms_for_step(tcfg, 0, peers)
    toks = lm_tokens(30, (peers, 2, 33), cfg.vocab_size)
    tst, tloss, _ = tfn(go.GossipState(tstack, topt.init(tstack),
                                       torch.tensor(LM_TRAIN_STEP,
                                                    dtype=torch.int32)),
                        {"tokens": torch.from_numpy(toks[..., :-1].copy()),
                         "labels": torch.from_numpy(toks[..., 1:].copy())},
                        perm)
    # the reference's stacked step, jitted
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[jax_params(cfg, 20 + p) for p in range(peers)])
    opt = jmake_optimizer("sgd", jwarmup_cosine(3e-4, 100, 10_000))
    gcfg = JGossipConfig(merge="mu", exchange_dtype="int8")
    fn = jax.jit(jgo.make_gossip_train_step(_loss_fn(jcfg), opt, peers,
                                            gcfg), static_argnums=(2, 3))
    st, loss, _ = fn(jgo.GossipState(stacked, opt.init(stacked),
                                     jnp.int32(LM_TRAIN_STEP)),
                     _jax_batch(toks), tuple(int(v) for v in perm), None)
    flips, gap = 0, 0.0
    for rank, r in enumerate(four):
        t = r["train_gossip"]
        peer = rank // 2                       # (data, model) row-major
        assert t["loss"] == pytest.approx(float(tloss), rel=LOSS_RTOL)
        assert t["loss"] == pytest.approx(float(loss), rel=LOSS_RTOL)
        got = convert.lm_params_to_reference(cfg, tree_map(
            torch.from_numpy, t["params"]))
        mine = convert.lm_params_to_reference(cfg, tree_map(
            lambda a: a[peer], tst.params))
        want = jax.tree.map(lambda a: a[peer], st.params)
        for g, m, w in zip(tree_leaves(got), tree_leaves(mine),
                           jax.tree.leaves(want)):
            gap = max(gap, close(g.numpy(), m.numpy(), PARAM_TOL,
                                 "params vs the stacked port"))
            w = np.asarray(w)
            off = np.abs(g.numpy() - w) > PARAM_TOL * np.abs(w).max()
            # XLA's fused int8 encode rounds a few codes the other way
            # (tests/test_torch_lm_train.py's allowance for the int8
            # exchange): at most 1 % of a leaf, within 1e-2 of its top
            assert off.mean() <= 0.01
            close(g.numpy(), w, 1e-2, "params")
            flips += int(off.sum())
        assert t["params_pl"]["blocks/0/ffn/w_up"] == ["S(1)"]   # TP
    print("gap to the stacked port", gap,
          "int8 codes rounded the other way by XLA:", flips)
