"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
package's ``repro/models/moe.py`` on the CPU.

Seeded numpy inputs and seeded weights (the port's, moved to JAX) go
through ``moe_ffn`` of
both packages at reduced widths: swiglu and gelu experts, top-1 and top-2
routing, one and two dispatch groups, a capacity that drops assignments,
and exactly tied router probabilities (zero router weights), where the
reference's ``jax.lax.top_k`` takes the lower expert first. The router's
choices, each assignment's slot and the keep mask are held equal to the
reference's own computation (``moe_ffn``'s router lines, run with JAX
ops), ``drop_fraction`` exactly, and the output and ``load_balance_loss``
within rtol 1e-5 and an atol of 1e-6 times the largest magnitude: float32
on both sides, differing only in the order of the expert products' sums.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import MoEConfig as JMoEConfig
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.config.base import MoEConfig
from repro_torch.models import layers, moe

RTOL, ATOL = 1e-5, 1e-6
D_MODEL = 48


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


def weights(m: JMoEConfig, act: str, seed: int, zero_router=False,
            dtype=torch.float32):
    """The port's ``moe_spec`` drawn by its ``init_params`` from a
    generator seeded with ``seed``, and the JAX package's copy (the
    reference's own ``init_params`` seeds its leaves with Python's
    per-process string hash, so its weights change from run to run)."""
    spec = moe.moe_spec(D_MODEL, MoEConfig(**dataclasses.asdict(m)), act,
                        dtype)
    p = layers.init_params(spec, torch.Generator().manual_seed(seed), "cpu")
    tp = {k: v.detach() for k, v in p.named_parameters()}
    if zero_router:
        tp["router"] = torch.zeros_like(tp["router"])
    jp = {k: jnp.asarray(convert._np(v).view(jnp.bfloat16)
                         if v.dtype == torch.bfloat16 else convert._np(v))
          for k, v in tp.items()}
    return jp, tp


def reference_route(jp, m: JMoEConfig, x):
    """The reference's router: ``moe_ffn``'s lines from the logits to the
    keep mask, with JAX ops."""
    B, S, D = x.shape
    T = B * S
    G = (m.dispatch_groups
         if m.dispatch_groups > 0 and T % m.dispatch_groups == 0 else 1)
    Tg = T // G
    C = jmoe._capacity(Tg, m)
    xt = jnp.asarray(x).reshape(G, Tg, D)
    logits = (xt.astype(jnp.float32) @ jp["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, m.top_k)
    if m.top_k > 1:
        gate_vals = gate_vals / jnp.sum(gate_vals, axis=-1, keepdims=True)
    flat = expert_idx.reshape(G, Tg * m.top_k)
    onehot = jax.nn.one_hot(flat, m.num_experts, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=1) - 1
    slot = jnp.take_along_axis(pos, flat[..., None], axis=2)[..., 0]
    return (np.asarray(probs), np.asarray(gate_vals), np.asarray(expert_idx),
            np.asarray(slot), np.asarray(slot < C), C)


CASES = {
    # name: (experts, top_k, capacity factor, dispatch groups, act, zero router)
    "top2_swiglu": (4, 2, 1.25, 1, "swiglu", False),
    "top1_swiglu": (4, 1, 1.25, 1, "swiglu", False),
    "top2_gelu": (4, 2, 1.25, 1, "gelu", False),
    "top2_groups2": (4, 2, 1.25, 2, "swiglu", False),
    "top2_drops": (8, 2, 0.25, 1, "swiglu", False),
    "top1_drops_groups2": (4, 1, 0.3, 2, "gelu", False),
    "top2_ties": (4, 2, 1.25, 1, "swiglu", True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_matches_reference(case):
    e, k, cf, groups, act, zero = CASES[case]
    m = JMoEConfig(num_experts=e, top_k=k, d_ff_expert=64,
                   capacity_factor=cf, dispatch_groups=groups)
    pm = MoEConfig(**dataclasses.asdict(m))
    jp, tp = weights(m, act, seed=len(case), zero_router=zero)
    x = np.random.default_rng(len(case)).standard_normal(
        (2, 40, D_MODEL), dtype=np.float32)
    jout, jaux = jmoe.moe_ffn(jp, m, jnp.asarray(x), act)
    out, aux = moe.moe_ffn(tp, pm, torch.from_numpy(x), act)
    close(out, jout)
    close(aux["load_balance_loss"], jaux["load_balance_loss"])
    assert float(aux["drop_fraction"]) == float(jaux["drop_fraction"])
    # the router's choices, slots and keep mask equal the reference's
    want = reference_route(jp, m, x)
    got = moe.route(tp, pm, torch.from_numpy(x))
    close(got[0], want[0])
    close(got[1], want[1])
    for g, w in zip(got[2:5], want[2:5]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[5] == want[5]
    if zero:          # uniform probabilities: the lower experts first
        assert (got[2].numpy() == np.arange(k)).all()
    if "drops" in case or zero:
        assert float(aux["drop_fraction"]) > 0


@pytest.mark.parametrize("tokens", [1, 8, 40, 1000])
@pytest.mark.parametrize("e,k,cf", [(8, 2, 1.25), (16, 1, 1.25),
                                    (4, 2, 0.3)])
def test_capacity_matches_reference(tokens, e, k, cf):
    m = JMoEConfig(num_experts=e, top_k=k, d_ff_expert=8,
                   capacity_factor=cf)
    assert moe._capacity(tokens, MoEConfig(**dataclasses.asdict(m))) == \
        jmoe._capacity(tokens, m)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_spec_matches_reference(act):
    m = JMoEConfig(num_experts=4, top_k=2, d_ff_expert=64)
    jspec = jmoe.moe_spec(D_MODEL, m, act, jnp.bfloat16)
    spec = moe.moe_spec(D_MODEL, MoEConfig(**dataclasses.asdict(m)), act,
                        torch.bfloat16)
    assert sorted(spec) == sorted(jspec)
    for name, p in spec.items():
        assert p.shape == jspec[name].shape
        assert p.init == jspec[name].init
        assert str(p.dtype)[6:] == np.dtype(jspec[name].dtype).name
    assert spec["router"].dtype == torch.float32


def test_moe_ffn_bf16_matches_reference_routing():
    """bf16 activations and weights (the full configs' dtypes): the same
    experts and slots as the reference, outputs within bf16 rounding."""
    m = JMoEConfig(num_experts=4, top_k=2, d_ff_expert=64)
    jp, tp = weights(m, "swiglu", 3, dtype=torch.bfloat16)
    assert jp["w_up"].dtype == jnp.bfloat16
    x = np.random.default_rng(3).standard_normal((2, 24, D_MODEL),
                                                 dtype=np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jout, jaux = jmoe.moe_ffn(jp, m, jx, "swiglu")
    pm = MoEConfig(**dataclasses.asdict(m))
    out, aux = moe.moe_ffn(tp, pm, tx, "swiglu")
    assert out.dtype == torch.bfloat16
    want = reference_route(jp, m, jx)
    got = moe.route(tp, pm, tx)
    for g, w in zip(got[2:5], want[2:5]):
        np.testing.assert_array_equal(g.numpy(), w)
    jo = np.asarray(jout.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), jo, rtol=2 ** -6,
                               atol=2 ** -6 * float(np.abs(jo).max()))
    assert float(aux["drop_fraction"]) == float(jaux["drop_fraction"])


def test_pinned_experts_route_as_given():
    """``route(experts=)``: its own choice gives the same routing; another
    choice gets the probabilities at those experts as gates (renormalised)
    and its slots and keep mask by the same cumsum."""
    m = MoEConfig(num_experts=4, top_k=2, d_ff_expert=64,
                  capacity_factor=0.5)
    jm = JMoEConfig(**dataclasses.asdict(m))
    _, tp = weights(jm, "swiglu", seed=9)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 20, D_MODEL), dtype=np.float32))
    own = moe.route(tp, m, x)
    again = moe.route(tp, m, x, experts=own[2])
    for a, b in zip(own[:5], again[:5]):
        assert torch.equal(a, b)
    other = torch.flip(own[2], dims=[-1]).roll(1, dims=1)
    probs, gates, experts, slot, keep, c = moe.route(tp, m, x,
                                                     experts=other)
    assert torch.equal(experts, other)
    at = torch.gather(probs, -1, other)
    assert torch.allclose(gates, at / at.sum(-1, keepdim=True))
    flat = other.reshape(-1).numpy()
    want = np.array([np.sum(flat[:i] == e) for i, e in enumerate(flat)])
    np.testing.assert_array_equal(slot.reshape(-1).numpy(), want)
    np.testing.assert_array_equal(keep.reshape(-1).numpy(), want < c)
