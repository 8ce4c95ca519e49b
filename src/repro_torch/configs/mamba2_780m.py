"""Mamba2-780m [arXiv:2405.21060] — attention-free SSD, d_ff = 0. A copy of
``repro/configs/mamba2_780m.py``."""
import torch

from repro_torch.config import ModelConfig, SSMConfig, register_config


@register_config("mamba2-780m")
def mamba2_780m() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        family="ssm",
        num_layers=48,
        d_model=1536,
        d_ff=0,                # attention-free, FFN-free (Mamba only)
        vocab_size=50_280,
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1,
                      chunk_size=256),
        layer_pattern=("ssm",),
        tie_embeddings=True,
        param_dtype=torch.float32,
        citation="[arXiv:2405.21060]",
    )
