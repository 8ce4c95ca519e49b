"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E] — MoE 16
experts top-1. A copy of ``repro/configs/llama4_scout.py``; its
``sharding="expert"`` names the reference's expert-parallel profile and
means nothing on one card."""
import torch

from repro_torch.config import (AttentionConfig, MoEConfig, ModelConfig,
                                register_config)


@register_config("llama4-scout-17b-a16e")
def llama4_scout() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        num_layers=48,
        d_model=5120,
        d_ff=8192,
        vocab_size=202_048,
        attention=AttentionConfig(num_heads=40, num_kv_heads=8, head_dim=128,
                                  rope_theta=500_000.0,
                                  sliding_window=8192),
        moe=MoEConfig(num_experts=16, top_k=1, d_ff_expert=8192,
                      sharding="expert"),
        layer_pattern=("attn",),
        param_dtype=torch.bfloat16,
        citation="[hf:meta-llama/Llama-4-Scout-17B-16E]",
    )
