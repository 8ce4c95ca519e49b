"""RecurrentGemma-9B [arXiv:2402.19427] — RG-LRU + local attention, 2:1.
A copy of ``repro/configs/recurrentgemma_9b.py``: the pattern (rglru,
rglru, local), window 2048; 38 layers are 12 periods and 2 rglru layers."""
import torch

from repro_torch.config import (AttentionConfig, ModelConfig, RGLRUConfig,
                                register_config)


@register_config("recurrentgemma-9b")
def recurrentgemma_9b() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,
        d_model=4096,
        d_ff=12_288,
        vocab_size=256_000,
        attention=AttentionConfig(num_heads=16, num_kv_heads=1, head_dim=256,
                                  rope_theta=10_000.0),
        rglru=RGLRUConfig(lru_width=4096, d_conv=4, num_heads=16, c=8.0,
                          local_window=2048),
        layer_pattern=("rglru", "rglru", "local"),
        act="gelu",
        param_dtype=torch.bfloat16,
        citation="[arXiv:2402.19427]",
    )
