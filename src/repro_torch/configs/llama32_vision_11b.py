"""Llama-3.2-11B-Vision [hf:meta-llama/Llama-3.2-11B-Vision] — VLM. A copy
of ``repro/configs/llama32_vision_11b.py``: 40 layers, gated
cross-attention to the vision patch embeddings every 5th layer (4 self + 1
cross, 8 periods). The ViT encoder and projector are stubbed, as in the
reference: ``models/vision.py`` draws the (B, 1601, 4096) patch embeddings
of one 448 px tile."""
import torch

from repro_torch.config import (AttentionConfig, CrossAttnConfig, ModelConfig,
                                register_config)


@register_config("llama-3.2-vision-11b")
def llama32_vision_11b() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        num_layers=40,
        d_model=4096,
        d_ff=14_336,
        vocab_size=128_256,
        attention=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                                  rope_theta=500_000.0),
        cross_attn=CrossAttnConfig(every_n_layers=5, source_len=1601,
                                   gated=True),
        layer_pattern=("attn", "attn", "attn", "attn", "cross"),
        param_dtype=torch.bfloat16,
        citation="[hf:meta-llama/Llama-3.2-11B-Vision]",
    )
