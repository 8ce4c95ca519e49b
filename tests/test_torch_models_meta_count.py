"""``launch/roofline.py``'s count on ``meta`` tensors, on the CPU.

A reduced dense (qwen3-8b: GQA 4:1, qk-norm) and a reduced MoE
(mixtral-8x22b: 4 experts, top-2) prefill, as the reference's
``build_prefill_step`` runs it (``forward(..., last_only=True)``) on
``launch/specs.py``'s inputs and ``transformer.abstract_params``, with
``attn_impl="xla"``: the matmul FLOPs ``FlopCounterMode`` counts equal a
hand count from the config, exactly (integers). The count allocates
nothing: a tensor off ``meta`` raises, and so does kernel #8, which has
no ``meta`` route. The loss's gradient on ``meta`` counts three times
the forward's matmuls, the recomputed loss head four.
"""
import pytest
import torch

from repro_torch.config import InputShape, get_config, reduced_config
from repro_torch.launch import roofline, specs
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.utils.tree import tree_leaves

B, S = 2, 96


def prefill(cfg):
    shape = InputShape("prefill", S, B, "prefill")
    batch = specs.input_specs(cfg, shape)

    def step(params, batch):
        return T.forward(params, cfg, batch["tokens"], last_only=True)[0]
    return step, T.abstract_params(cfg), batch, shape


def hand_count(cfg) -> int:
    """The prefill's matmul FLOPs from the config: per layer the q, k, v
    and o projections, the logits and P V over all S x S pairs (the plain
    path masks, it does not skip), the FFN (MoE: the router and each
    expert's three products over its capacity), then the head at the last
    position."""
    a, d, t = cfg.attention, cfg.d_model, B * S
    hq, hkv = a.num_heads * a.head_dim, a.num_kv_heads * a.head_dim
    per_layer = 2 * t * d * (hq + 2 * hkv + hq) + 2 * 2 * B * S * S * hq
    if cfg.moe is None:
        per_layer += 3 * 2 * t * d * cfg.d_ff
    else:
        m = cfg.moe
        c = moe._capacity(t, m)
        per_layer += 2 * t * d * m.num_experts
        per_layer += 3 * 2 * m.num_experts * c * d * m.d_ff_expert
    return cfg.num_layers * per_layer + 2 * B * d * cfg.vocab_size


@pytest.mark.parametrize("arch", ["qwen3-8b", "mixtral-8x22b"])
def test_meta_count_of_a_prefill_equals_the_hand_count(arch):
    cfg = reduced_config(get_config(arch)).replace(attn_impl="xla")
    step, params, batch, shape = prefill(cfg)
    flops, nbytes, logits = roofline.count(step, params, batch)
    assert flops == hand_count(cfg)
    assert logits.device.type == "meta"
    assert tuple(logits.shape) == (B, cfg.vocab_size)
    # every parameter byte is read at least once
    assert nbytes > sum(p.numel() * p.element_size()
                        for p in tree_leaves(params))
    r = roofline.analyze(step, params, batch,
                         model_flops=roofline.model_flops_for(cfg, shape))
    assert r.flops_per_device == flops and r.chips == 1
    assert r.collective_s == 0.0 and r.collectives == {}
    assert r.compute_s == pytest.approx(flops / 989e12)
    assert r.dominant in ("compute", "memory")
    assert r.useful_ratio == pytest.approx(r.model_flops / flops)


def test_a_training_step_counts_three_forwards():
    """The loss's gradient on ``meta``: each product of the layers counted
    three times (forward, and the gradients of both operands), the head
    four (its loss chunk is recomputed in the backward pass)."""
    cfg = reduced_config(get_config("qwen3-8b")).replace(
        attn_impl="xla", remat=False, xent_chunk=S)
    shape = InputShape("train", S, B, "train")
    batch = specs.input_specs(cfg, shape)
    params = T.abstract_params(cfg)

    def loss_and_grad(params, batch):
        leaves = [p.requires_grad_(True) for p in
                  tree_leaves(params)]
        loss, _ = T.lm_loss(params, cfg, batch["tokens"], batch["labels"])
        return torch.autograd.grad(loss, leaves)
    flops, _, grads = roofline.count(loss_and_grad, params, batch)
    head = 2 * B * S * cfg.d_model * cfg.vocab_size
    layers = hand_count(cfg) - 2 * B * cfg.d_model * cfg.vocab_size
    assert flops == 3 * layers + 4 * head
    assert all(g.device.type == "meta" for g in grads)


def test_the_count_allocates_nothing():
    cfg = reduced_config(get_config("qwen3-8b")).replace(attn_impl="xla")
    step, params, batch, _ = prefill(cfg)
    with pytest.raises(ValueError, match="meta"):
        roofline.count(step, params, {"tokens": torch.zeros(
            (B, S), dtype=torch.int32)})
    flash = cfg.replace(attn_impl="flash")
    with pytest.raises(NotImplementedError, match="meta"):
        roofline.count(lambda p, b: T.forward(p, flash, b["tokens"],
                                              last_only=True),
                       params, batch)
