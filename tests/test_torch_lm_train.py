"""The port's LM training path against the JAX package: the ``"chunked"``
attention, ``lm_loss`` and its gradient, and gossip and all-reduce train
steps on a reduced LM (``launch/train.py``: tests/test_torch_train_launch.py).

Configs: qwen3-1.7b reduced to d_model 64, 2 layers, vocab 256, S = 32,
with ``attn_chunk`` 8 and ``xent_chunk`` 16 below S and a sliding window
of 12 where stated, so several query chunks, the window's key span
(24 of 32 keys) and several loss chunks run; the port's seeded weights
moved to JAX by ``convert.lm_params_to_arrays``, a JAX gossip state back
by ``gossip_state_from_arrays``.

Tolerances, measured on these inputs and stated per test:
- float32 compute: the loss within rtol 1e-6 (measured equal), every
  gradient leaf within 1e-5 of its largest value (measured 1.4e-6);
- bfloat16 compute: the loss within 1e-3 (measured 1.2e-4), gradients
  within 5e-2 of the leaf's largest value (measured 1.6e-2: bf16
  activations round at other points of XLA's fused graph);
- three gossip steps (mu + adamw, um + sgdm + int8 exchange, rw + sgd)
  against the reference's jitted step: losses within rtol 1e-5 (measured
  1.7e-7), parameters and float32 optimizer state within 1e-4 of the
  leaf's largest value (measured 1.6e-5, AdamW), SGD-momentum's bfloat16
  buffer within one bfloat16 ulp of it (4 of 16 384 elements one ulp
  apart). Under the int8 exchange up to 1 % of a leaf's elements may
  differ more, within 1e-2 of its largest value, where the two packages'
  inputs to the encode differ by an ulp at a rounding boundary and a code
  or a row's f16 scale rounds the other way (measured 0.195 % of the
  embedding's elements, two rows, at 4.4e-3); ``step`` exact."""
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
from repro.models import attention as jattn
from repro.models import transformer as JT
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch import convert
from repro_torch.config import GossipConfig
from repro_torch.core import gossip_optimizer as go
from repro_torch.models import attention as attn
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.utils.tree import tree_leaves, tree_map

PEERS = 4


def reduced(window=None, compute=jnp.float32, **kw):
    jcfg = jreduced_config(jget_config("qwen3-1.7b"), d_model=64, layers=2,
                           vocab=256)
    jcfg = jcfg.replace(attn_chunk=8, xent_chunk=16, compute_dtype=compute,
                        **kw)
    if window is not None:
        jcfg = jcfg.replace(attention=dataclasses.replace(
            jcfg.attention, sliding_window=window))
    cfg = convert.model_config_from_dict(dataclasses.asdict(jcfg))
    return jcfg, cfg.replace(attn_impl="chunked")


def pinned(jcfg, cfg, seed):
    """The port's parameters from a generator seeded with ``seed`` on the
    CPU, and the JAX package's copy of them (the reference's own
    ``init_params`` seeds its leaves with Python's per-process string
    hash, so its weights change from run to run)."""
    params = T.init_params(cfg, device="cpu", seed=seed)
    return (jax.tree.map(jnp.asarray, convert.lm_params_to_arrays(cfg,
                                                                 params)),
            params)


def tokens(seed, shape):
    t = np.random.default_rng(seed).integers(0, 256, shape + (33,))
    return t[..., :-1].astype(np.int32), t[..., 1:].astype(np.int32)


def close_trees(got, want, frac, what, flips=None):
    """Leaves within ``frac`` of the leaf's largest value, a bfloat16 leaf
    within one bfloat16 ulp of it (2^-8); ``got`` from
    ``convert.lm_params_to_arrays`` (bfloat16 as its uint16 bits). With
    ``flips = (share, far)``, up to ``share`` of a leaf's elements may lie
    beyond that, but within ``far`` of the largest value: a quantized
    exchange rounds a code, or a row's f16 scale, the other way where the
    two packages' inputs differ by an ulp on a rounding boundary."""
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        tol = frac
        if np.asarray(w).dtype == jnp.bfloat16:
            g = np.asarray(g).view(jnp.bfloat16)
            tol = max(frac, 2.0 ** -8)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, what
        top = float(np.abs(w).max())
        if flips is not None:
            off = np.abs(np.asarray(g, np.float32) - w)
            assert (off > tol * top).mean() <= flips[0], what
            tol = flips[1]
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=0,
                                   atol=tol * top, err_msg=what)


@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("chunk", [8, 32])
def test_chunked_attention_matches_the_reference(window, chunk):
    jcfg, cfg = reduced(window=window)
    jp = jax.tree.map(lambda a: a[0],
                      pinned(jcfg, cfg, 1)[0]["blocks"]["l0"])
    p = tree_map(lambda a: torch.from_numpy(np.asarray(a).copy()),
                 jp["attn"])
    x = np.random.default_rng(2).standard_normal((2, 32, 64),
                                                 dtype=np.float32)
    want = jattn.attention(jp["attn"], jcfg.attention, jnp.asarray(x),
                           compute_dtype=jnp.float32, impl="chunked",
                           attn_chunk=chunk)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = attn.attention(p, cfg.attention, xt, compute_dtype=torch.float32,
                         impl="chunked", attn_chunk=chunk)
    # within 1e-6 of the largest output (measured up to 1.7e-7: the
    # einsums' blocking, which varies with the CPU's threads, moves the
    # last bits)
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))
    # differentiable, and the same gradient as the one-block attention
    got.square().sum().backward()
    xs = torch.from_numpy(x).requires_grad_(True)
    attn.attention(p, cfg.attention, xs, compute_dtype=torch.float32,
                   impl="xla").square().sum().backward()
    # (measured 1.3e-7 of the largest gradient: the chunks' matmuls sum in
    # another order)
    torch.testing.assert_close(xt.grad, xs.grad, rtol=0,
                               atol=1e-6 * float(xs.grad.abs().max()))


def test_chunked_attention_needs_a_multiple_of_the_chunk():
    _, cfg = reduced()
    p = tree_map(lambda a: a.detach(), T.init_params(cfg, device="cpu"))
    with pytest.raises(ValueError, match="chunk"):
        attn.attention(p["blocks"][0]["attn"], cfg.attention,
                       torch.zeros((1, 20, 64)), impl="chunked",
                       attn_chunk=8)


@pytest.mark.parametrize("compute,loss_tol,grad_frac",
                         [(jnp.float32, 1e-6, 1e-5),
                          (jnp.bfloat16, 1e-3, 5e-2)])
@pytest.mark.parametrize("window", [None, 12])
def test_lm_loss_and_gradient_match_jax_value_and_grad(window, compute,
                                                       loss_tol, grad_frac):
    jcfg, cfg = reduced(window=window, compute=compute)
    jp, params = pinned(jcfg, cfg, 0)
    tok, lab = tokens(1, (2,))
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JT.lm_loss(p, jcfg, jnp.asarray(tok), jnp.asarray(lab)),
        has_aux=True)(jp)
    tree = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = T.lm_loss(tree, cfg, torch.from_numpy(tok),
                              torch.from_numpy(lab))
    loss.backward()
    assert set(metrics) == {"nll", "aux"} and float(metrics["aux"]) == 0.0
    loss = float(loss.detach())
    if compute == jnp.float32:
        assert loss == pytest.approx(float(jl), rel=loss_tol)
    else:
        assert abs(loss - float(jl)) <= loss_tol
    grads = convert.lm_params_to_arrays(cfg, tree_map(lambda p: p.grad, tree))
    close_trees(grads, jg, grad_frac, f"gradient ({compute.__name__})")


def test_remat_and_loss_chunks_leave_the_bits():
    """Recomputing each layer in the backward pass, and the loss chunk,
    change no bit of the loss or the gradient."""
    _, cfg = reduced(window=12)
    params = tree_map(lambda p: p.detach(), T.init_params(cfg, device="cpu"))
    tok, lab = (torch.from_numpy(a) for a in tokens(2, (2,)))
    outs = []
    for remat, chunk in ((False, 16), (True, 16), (False, 32)):
        c = cfg.replace(remat=remat)
        tree = tree_map(lambda p: p.clone().requires_grad_(True), params)
        loss, _ = T.lm_loss(tree, c, tok, lab, seq_chunk=chunk)
        loss.backward()
        outs.append([loss.detach()] + [p.grad for p in tree_leaves(tree)])
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    assert float(outs[2][0]) == pytest.approx(float(outs[0][0]), rel=1e-6)


@pytest.mark.parametrize("merge,optimizer,exchange",
                         [("mu", "adamw", ""), ("um", "sgdm", "int8"),
                          ("rw", "sgd", "")])
def test_gossip_lm_steps_match_the_reference(merge, optimizer, exchange):
    jcfg, cfg = reduced()
    jcfg = jcfg.replace(attn_chunk=16)
    cfg = cfg.replace(attn_chunk=16)
    jo = jmake_optimizer(optimizer, jwarmup_cosine(3e-3, 2, 10))
    to = make_optimizer(optimizer, warmup_cosine(3e-3, 2, 10))
    sp = jgo.stack_for_peers(pinned(jcfg, cfg, 0)[0], PEERS)
    js = jgo.GossipState(sp, jo.init(sp), jnp.zeros((), jnp.int32))
    a = jax.tree.map(np.asarray, js)
    ts = convert.gossip_state_from_arrays(a.params, a.opt_state, a.step,
                                          "cpu", cfg=cfg)
    jcf = JGossipConfig(merge=merge, exchange_dtype=exchange)
    tcf = GossipConfig(merge=merge, exchange_dtype=exchange)
    jfn = jax.jit(jgo.make_gossip_train_step(
        lambda p, b: JT.lm_loss(p, jcfg, b["tokens"], b["labels"]), jo,
        PEERS, jcf), static_argnums=(2, 3))
    tfn = go.make_gossip_train_step(
        lambda p, b: T.lm_loss(p, cfg, b["tokens"], b["labels"]), to, PEERS,
        tcf)
    for s in range(3):
        tok, lab = tokens(10 + s, (PEERS, 2))
        perm, _ = jgo.perms_for_step(jcf, s, PEERS)
        js, jl, jm = jfn(js, {"tokens": jnp.asarray(tok),
                              "labels": jnp.asarray(lab)},
                         tuple(int(v) for v in perm), None)
        ts, tl, tm = tfn(ts, {"tokens": torch.from_numpy(tok),
                              "labels": torch.from_numpy(lab)}, perm)
        assert int(ts.step) == int(js.step) == s + 1
        assert float(tl) == pytest.approx(float(jl), rel=1e-5)
        assert tm["nll"].shape == (PEERS,)
    flips = (0.01, 1e-2) if exchange else None
    close_trees(convert.lm_params_to_arrays(cfg, ts.params, lead=1),
                js.params, 1e-4, f"{merge} params", flips)
    for k in ts.opt_state:
        close_trees(convert.lm_params_to_arrays(cfg, ts.opt_state[k], lead=1),
                    js.opt_state[k], 1e-4, f"{merge} {k}", flips)


def test_allreduce_lm_steps_match_the_reference():
    jcfg, cfg = reduced()
    jo = jmake_optimizer("adamw", jwarmup_cosine(3e-3, 2, 10))
    to = make_optimizer("adamw", warmup_cosine(3e-3, 2, 10))
    jp, tp = pinned(jcfg, cfg, 3)
    tp = tree_map(lambda p: p.detach(), tp)
    js, ts = jo.init(jp), to.init(tp)
    jfn = jax.jit(jgo.make_allreduce_train_step(
        lambda p, b: JT.lm_loss(p, jcfg, b["tokens"], b["labels"]), jo))
    tfn = go.make_allreduce_train_step(
        lambda p, b: T.lm_loss(p, cfg, b["tokens"], b["labels"]), to)
    for s in range(3):
        tok, lab = tokens(20 + s, (4,))
        jp, js, jl, _ = jfn(jp, js, {"tokens": jnp.asarray(tok),
                                     "labels": jnp.asarray(lab)},
                            jnp.int32(s))
        tp, ts, tl, _ = tfn(tp, ts, {"tokens": torch.from_numpy(tok),
                                     "labels": torch.from_numpy(lab)},
                            torch.tensor(s, dtype=torch.int32))
        assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    close_trees(convert.lm_params_to_arrays(cfg, tp), jp, 1e-4, "params")
