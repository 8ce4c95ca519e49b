"""Training the moe, ssm and hybrid families: the port's ``lm_loss`` and
its gradient against the jitted ``jax.value_and_grad`` of the JAX
package's, and one gossip train step of each family against the
reference's jitted step, on the CPU.

Reduced ``mixtral-8x22b`` (4 experts, top-2, window 64),
``llama4-scout-17b-a16e`` (top-1, window 64), ``mamba2-780m`` (SSD,
chunk 32) and ``recurrentgemma-9b`` (rglru, rglru, local with window 32)
at d_model 64, vocab 256, S = 80: past the windows, two and a half SSD
chunks (the padded path and the decays across chunks), the RG-LRU scan's
log-depth steps over 80 positions, ``attn_chunk`` and ``xent_chunk`` 16.
The MoE pair runs also at a capacity factor of 0.5, whose capacity (40
slots an expert for mixtral's 320 assignments, 20 for llama4-scout's 160)
drops assignments, so the gradient flows through the dropped ones' zeros.
The loss and gradient of the dense ``llama3-405b`` (GQA 16:1) reduced the
same way are held too.
Weights: the port's seeded ``init_params`` moved to JAX by
``convert.lm_params_to_arrays`` (the reference's own init seeds by
Python's per-process string hash).

Bars, ``tests/test_torch_lm_train.py``'s at float32: the loss (with the
MoE ``aux``) within rtol 1e-6, every gradient leaf within 1e-5 of the
leaf's largest value (measured up to 4.6e-6); the gossip step (mu, AdamW,
the float32 exchange): the loss within rtol 1e-5, parameters and both
AdamW moments within 1e-4 of the leaf's largest value.
"""
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
from repro.models import transformer as JT
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch import convert
from repro_torch.config import GossipConfig
from repro_torch.core import gossip_optimizer as go
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.utils.tree import tree_leaves, tree_map

ARCHS = ["mixtral-8x22b", "llama4-scout-17b-a16e", "mamba2-780m",
         "recurrentgemma-9b"]
S, VOCAB, PEERS = 80, 256, 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs (many small ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reduced(arch, capacity=None):
    jcfg = jreduced_config(jget_config(arch), d_model=64, vocab=VOCAB)
    jcfg = jcfg.replace(attn_chunk=16, xent_chunk=16)
    if capacity is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity))
    cfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))
    return jcfg, cfg.replace(attn_impl="chunked")


def pinned(jcfg, cfg, seed=0):
    params = T.init_params(cfg, device="cpu", seed=seed)
    return (jax.tree.map(jnp.asarray, convert.lm_params_to_arrays(cfg,
                                                                 params)),
            params)


def tokens(seed, shape):
    t = np.random.default_rng(seed).integers(0, VOCAB, shape + (S + 1,))
    return t[..., :-1].astype(np.int32), t[..., 1:].astype(np.int32)


def close_trees(got, want, frac, what):
    """Every leaf within ``frac`` of the want leaf's largest value."""
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, what
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=0,
                                   atol=frac * float(np.abs(w).max()),
                                   err_msg=what)


# and the dense llama3-405b (GQA 16:1), whose loss no other test holds
CASES = ([(a, None) for a in ARCHS] + [(a, 0.5) for a in ARCHS[:2]]
         + [("llama3-405b", None)])


@pytest.mark.parametrize("arch,capacity", CASES)
def test_lm_loss_and_gradient_match_jax_value_and_grad(arch, capacity):
    jcfg, cfg = reduced(arch, capacity)
    jp, params = pinned(jcfg, cfg)
    tok, lab = tokens(1, (2,))
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(p, jcfg, jnp.asarray(tok), jnp.asarray(lab)),
        has_aux=True))(jp)
    tree = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                    params)
    loss, metrics = T.lm_loss(tree, cfg, torch.from_numpy(tok),
                              torch.from_numpy(lab))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-6)
    aux = float(metrics["aux"].detach())
    assert aux == pytest.approx(float(jm["aux"]), rel=1e-6, abs=1e-9)
    if cfg.moe is not None:
        assert aux > 0.0
    grads = convert.lm_params_to_arrays(cfg, tree_map(lambda p: p.grad, tree))
    close_trees(grads, jg, 1e-5, f"{arch} gradient")


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "mamba2-780m",
                                  "recurrentgemma-9b"])
def test_gossip_step_matches_the_reference(arch):
    """One step of each family: moe (mixtral), ssm and hybrid."""
    jcfg, cfg = reduced(arch)
    jo = jmake_optimizer("adamw", jwarmup_cosine(3e-3, 2, 10))
    to = make_optimizer("adamw", warmup_cosine(3e-3, 2, 10))
    sp = jgo.stack_for_peers(pinned(jcfg, cfg)[0], PEERS)
    js = jgo.GossipState(sp, jo.init(sp), jnp.zeros((), jnp.int32))
    a = jax.tree.map(np.asarray, js)
    ts = convert.gossip_state_from_arrays(a.params, a.opt_state, a.step,
                                          "cpu", cfg=cfg)
    jcf, tcf = JGossipConfig(merge="mu"), GossipConfig(merge="mu")
    jfn = jax.jit(jgo.make_gossip_train_step(
        lambda p, b: JT.lm_loss(p, jcfg, b["tokens"], b["labels"]), jo,
        PEERS, jcf), static_argnums=(2, 3))
    tfn = go.make_gossip_train_step(
        lambda p, b: T.lm_loss(p, cfg, b["tokens"], b["labels"]), to, PEERS,
        tcf)
    tok, lab = tokens(10, (PEERS, 1))
    perm, _ = jgo.perms_for_step(jcf, 0, PEERS)
    js, jl, _ = jfn(js, {"tokens": jnp.asarray(tok),
                         "labels": jnp.asarray(lab)},
                    tuple(int(v) for v in perm), None)
    ts, tl, tm = tfn(ts, {"tokens": torch.from_numpy(tok),
                          "labels": torch.from_numpy(lab)}, perm)
    assert int(ts.step) == int(js.step) == 1
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert tm["nll"].shape == (PEERS,)
    close_trees(convert.lm_params_to_arrays(cfg, ts.params, lead=1),
                js.params, 1e-4, f"{arch} params")
    for k in ("m", "v"):
        close_trees(convert.lm_params_to_arrays(cfg, ts.opt_state[k],
                                                lead=1),
                    js.opt_state[k], 1e-4, f"{arch} {k}")
