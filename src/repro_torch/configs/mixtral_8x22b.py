"""Mixtral-8x22B [arXiv:2401.04088] — MoE 8 experts top-2, sliding window.
A copy of ``repro/configs/mixtral_8x22b.py``; its ``sharding="tensor"``
names the reference's expert-sharding profile and means nothing on one
card."""
import torch

from repro_torch.config import (AttentionConfig, MoEConfig, ModelConfig,
                                register_config)


@register_config("mixtral-8x22b")
def mixtral_8x22b() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        num_layers=56,
        d_model=6144,
        d_ff=16_384,
        vocab_size=32_768,
        attention=AttentionConfig(num_heads=48, num_kv_heads=8, head_dim=128,
                                  rope_theta=1_000_000.0,
                                  sliding_window=4096),
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16_384,
                      sharding="tensor"),
        layer_pattern=("attn",),
        param_dtype=torch.bfloat16,
        citation="[arXiv:2401.04088]",
    )
