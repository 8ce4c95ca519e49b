"""The vlm and audio frontends' stub inputs (Llama-3.2-Vision, Whisper).

Counterpart of ``repro/models/vision.py``. The ViT/SigLIP vision encoder
and projector, and Whisper's mel and conv frontend, are not implemented,
as in the reference: these helpers give the shapes of their outputs and
draw them as ``0.02 * normal`` from a threefry key, bit for bit
``jax.random.normal``'s words in bfloat16 and in float32
(``random.normal``). The gated cross-attention layers (kind ``"cross"``)
read the patch embeddings directly; the encoder (``models/encdec.py``)
reads the frames.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import random
from repro_torch.config.base import ModelConfig
from repro_torch.models.layers import meta


def patch_embedding_shape(cfg: ModelConfig, batch: int) -> Tuple[int, ...]:
    """The stubbed vision encoder's output: (B, n_patches, d_model) in the
    compute dtype."""
    if cfg.cross_attn is None:
        raise ValueError(f"{cfg.name} has no cross-attention")
    return (batch, cfg.cross_attn.source_len, cfg.d_model)


def frame_embedding_shape(cfg: ModelConfig, batch: int) -> Tuple[int, ...]:
    """The stubbed audio frontend's output: (B, source_len, d_model) in
    the compute dtype."""
    if cfg.encoder is None:
        raise ValueError(f"{cfg.name} has no encoder")
    return (batch, cfg.encoder.source_len,
            cfg.encoder.d_model or cfg.d_model)


def patch_embedding_spec(cfg: ModelConfig, batch: int) -> torch.Tensor:
    """The stubbed vision encoder's output as a ``meta`` tensor."""
    return meta(patch_embedding_shape(cfg, batch), cfg.compute_dtype)


def frame_embedding_spec(cfg: ModelConfig, batch: int) -> torch.Tensor:
    """The stubbed audio frontend's output as a ``meta`` tensor."""
    return meta(frame_embedding_shape(cfg, batch), cfg.compute_dtype)


def _dummy(key, shape, dtype):
    # the scale rounds to the draw's dtype first, as jax's weak-typed 0.02
    x = random.normal(key, shape, dtype)
    return x * torch.tensor(0.02, dtype=dtype, device=x.device)


def dummy_patch_embeddings(key, cfg: ModelConfig, batch: int):
    """``0.02 * normal(key)`` patch embeddings on ``key``'s device."""
    return _dummy(key, patch_embedding_shape(cfg, batch), cfg.compute_dtype)


def dummy_frame_embeddings(key, cfg: ModelConfig, batch: int):
    """``0.02 * normal(key)`` frame embeddings on ``key``'s device."""
    return _dummy(key, frame_embedding_shape(cfg, batch), cfg.compute_dtype)
