"""Whisper-medium [arXiv:2212.04356] — encoder-decoder; the mel and conv
frontend stubbed. A copy of ``repro/configs/whisper_medium.py``: 24
encoder and 24 decoder layers, d_model 1024, 16 heads (MHA), learned
decoder positions capped at 448 target positions, LayerNorm and GELU, tied
embeddings. ``models/vision.py`` draws the (B, 1500, 1024) frame
embeddings the conv frontend would give."""
import torch

from repro_torch.config import (AttentionConfig, EncoderConfig, ModelConfig,
                                register_config)


@register_config("whisper-medium")
def whisper_medium() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="audio",
        num_layers=24,
        d_model=1024,
        d_ff=4096,
        vocab_size=51_865,
        attention=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=64,
                                  use_rope=False),
        encoder=EncoderConfig(num_layers=24, source_len=1500),
        layer_pattern=("selfcross",),
        norm="layernorm",
        norm_eps=1e-5,
        act="gelu",
        tie_embeddings=True,
        max_target_positions=448,
        param_dtype=torch.float32,
        citation="[arXiv:2212.04356]",
    )
