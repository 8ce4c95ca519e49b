"""Architecture registry: ``--arch <id>`` resolution and reduced variants.

Counterpart of ``repro/config/registry.py``. The port registers every
architecture the reference does: the dense (``repro_torch/configs/qwen3_*``,
llama3-405b), moe (mixtral-8x22b, llama4-scout), ssm (mamba2-780m),
hybrid (recurrentgemma-9b), vlm (llama-3.2-vision-11b) and audio
(whisper-medium) configs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch.config.base import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register_config(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def _ensure_loaded() -> None:
    # importing repro_torch.configs registers everything
    import repro_torch.configs  # noqa: F401


def get_config(arch_id: str) -> ModelConfig:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_configs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def reduced_config(cfg: ModelConfig, *, d_model: int = 256, layers: int = 2,
                   vocab: int = 512, max_experts: int = 4) -> ModelConfig:
    """Shrink a config for CPU tests mechanically, as the reference does:
    the family, layer pattern, GQA ratio, qk-norm and windowing stay; the
    widths drop to CPU scale (<= 512 d_model, 2 layers, <= 4 experts) and
    the dtypes to float32."""
    attn = cfg.attention
    if attn is not None:
        ratio = max(1, attn.q_per_kv)
        heads = max(ratio, 4)
        heads -= heads % ratio
        head_dim = max(16, d_model // heads)
        head_dim -= head_dim % 8          # even head_dim for RoPE halves
        d_model = heads * head_dim
        attn = dataclasses.replace(
            attn, num_heads=heads, num_kv_heads=max(1, heads // ratio),
            head_dim=head_dim,
            sliding_window=(min(attn.sliding_window, 64)
                            if attn.sliding_window else None))
    moe = cfg.moe
    if moe is not None:
        n_e = min(moe.num_experts, max_experts)
        moe = dataclasses.replace(
            moe, num_experts=n_e, top_k=min(moe.top_k, n_e),
            d_ff_expert=2 * d_model)
    ssm = cfg.ssm
    if ssm is not None:
        ssm = dataclasses.replace(ssm, d_state=32, head_dim=32, chunk_size=32)
    rglru = cfg.rglru
    if rglru is not None:
        rglru = dataclasses.replace(rglru, lru_width=d_model, local_window=32,
                                    num_heads=4)
    enc = cfg.encoder
    if enc is not None:
        enc = dataclasses.replace(enc, num_layers=2, source_len=16)
    cross = cfg.cross_attn
    if cross is not None:
        cross = dataclasses.replace(cross, source_len=16)
        layers = max(layers, cross.every_n_layers)
    if cfg.rglru is not None:
        layers = max(layers, len(cfg.layer_pattern))
    return cfg.replace(
        name=cfg.name + "-smoke",
        num_layers=layers, d_model=d_model,
        d_ff=2 * d_model, vocab_size=vocab,
        attention=attn, moe=moe, ssm=ssm, rglru=rglru, encoder=enc,
        cross_attn=cross,
        param_dtype=torch.float32, compute_dtype=torch.float32,
        max_target_positions=(min(cfg.max_target_positions, 64)
                              if cfg.max_target_positions else 0),
        remat=False)
