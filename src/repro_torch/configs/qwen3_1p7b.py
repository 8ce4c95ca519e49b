"""Qwen3-1.7B [hf:Qwen/Qwen3-8B family] — dense, GQA kv=8, qk-norm. A copy of
``repro/configs/qwen3_1p7b.py``."""
import torch

from repro_torch.config import AttentionConfig, ModelConfig, register_config


@register_config("qwen3-1.7b")
def qwen3_1p7b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b",
        family="dense",
        num_layers=28,
        d_model=2048,
        d_ff=6144,
        vocab_size=151_936,
        attention=AttentionConfig(num_heads=16, num_kv_heads=8, head_dim=128,
                                  qk_norm=True, rope_theta=1_000_000.0),
        layer_pattern=("attn",),
        tie_embeddings=True,
        param_dtype=torch.bfloat16,
        citation="[hf:Qwen/Qwen3-8B]",
    )
