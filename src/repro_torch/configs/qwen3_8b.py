"""Qwen3-8B [hf:Qwen/Qwen3-8B] — dense, GQA kv=8, qk-norm. A copy of
``repro/configs/qwen3_8b.py``."""
import torch

from repro_torch.config import AttentionConfig, ModelConfig, register_config


@register_config("qwen3-8b")
def qwen3_8b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b",
        family="dense",
        num_layers=36,
        d_model=4096,
        d_ff=12288,
        vocab_size=151_936,
        attention=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                                  qk_norm=True, rope_theta=1_000_000.0),
        layer_pattern=("attn",),
        param_dtype=torch.bfloat16,
        citation="[hf:Qwen/Qwen3-8B]",
    )
