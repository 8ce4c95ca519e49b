"""Llama-3 405B [arXiv:2407.21783] — dense, GQA kv=8, 128k vocab. A copy
of ``repro/configs/llama3_405b.py``."""
import torch

from repro_torch.config import AttentionConfig, ModelConfig, register_config


@register_config("llama3-405b")
def llama3_405b() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b",
        family="dense",
        num_layers=126,
        d_model=16_384,
        d_ff=53_248,
        vocab_size=128_256,
        attention=AttentionConfig(num_heads=128, num_kv_heads=8, head_dim=128,
                                  rope_theta=500_000.0),
        layer_pattern=("attn",),
        param_dtype=torch.bfloat16,
        citation="[arXiv:2407.21783]",
    )
