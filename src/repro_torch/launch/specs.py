"""Input specs of the workload shapes, on ``meta`` tensors.

Counterpart of the mesh-free half of ``repro/launch/specs.py``: the
reference's ``ShapeDtypeStruct`` stand-ins become tensors on the ``meta``
device (shapes and dtypes, no storage), so a 405B-scale model's inputs
and half-terabyte decode caches are described without an allocation and
the model's own functions run on them (``launch/roofline.py``). The decode
cache keeps the port's layout (``transformer.cache_spec``: a list of
per-layer dicts, which ``decode_step`` takes);
``convert.lm_params_to_reference(cfg, {"blocks": cache})`` stacks it into
the reference's.

``shardings_for``, the batch specs and the ``build_*_step`` builders need
the LM's logical-axis sharding on a ``DeviceMesh`` and wait for the
mesh's second slice (ROADMAP queue 1 item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.config.base import InputShape, ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import meta
from repro_torch.models.vision import (frame_embedding_spec,
                                       patch_embedding_spec)

LONG_WINDOW = 8192          # SWA window for dense archs on long_500k


def resolve_variant(cfg: ModelConfig,
                    shape: InputShape) -> Tuple[ModelConfig, Dict]:
    """Adapt a config to a workload shape; returns (cfg, notes).

    * long_500k on full-attention archs -> sliding-window variant (the
      sub-quadratic requirement); natively windowed/SSM archs unchanged.
    * whisper: long_500k unsupported (documented skip); decode self-cache
      capped at max_target_positions.
    """
    notes: Dict = {}
    if shape.name == "long_500k":
        if cfg.family == "audio":
            raise ValueError("long_500k x whisper: documented skip (DESIGN.md)")
        a = cfg.attention
        if a is not None and a.sliding_window is None:
            has_global_attn = any(k in ("attn", "cross", "selfcross")
                                  for k in cfg.layer_pattern)
            if has_global_attn:
                cfg = cfg.replace(
                    attention=dataclasses.replace(a, sliding_window=LONG_WINDOW))
                notes["attn"] = f"swa{LONG_WINDOW}"
    if cfg.family == "audio" and shape.kind == "decode":
        notes["self_cache"] = (f"capped at {cfg.max_target_positions} target "
                               "positions")
    return cfg, notes


def needs_encoder_input(cfg: ModelConfig) -> bool:
    return cfg.family in ("vlm", "audio")


def encoder_input_spec(cfg: ModelConfig, batch: int) -> torch.Tensor:
    """The encoder-side input as a ``meta`` tensor: the patch embeddings
    (vlm) or the frames (audio), in the compute dtype (the reference's
    ``encoder_input_sds``)."""
    if cfg.family == "vlm":
        return patch_embedding_spec(cfg, batch)
    return frame_embedding_spec(cfg, batch)


def input_specs(cfg: ModelConfig, shape: InputShape, *,
                n_peers: int = 0) -> Dict:
    """``meta`` stand-ins for every model input of this workload: train
    ``tokens``/``labels`` (int32, (B, S), or (peers, B / peers, S) under
    gossip) and ``encoder_out``; prefill ``tokens`` and ``encoder_out``;
    decode ONE new ``token`` (B,), the ``cache`` of ``seq_len`` positions
    (``transformer.cache_spec``) and the 0-d ``index``."""
    gb, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        if n_peers:
            if gb % n_peers:
                raise ValueError(f"batch {gb} does not split over {n_peers} "
                                 "peers")
            tok = meta((n_peers, gb // n_peers, s), torch.int32)
        else:
            tok = meta((gb, s), torch.int32)
        out = {"tokens": tok, "labels": meta(tok.shape, torch.int32)}
        if needs_encoder_input(cfg):
            if n_peers:
                e = encoder_input_spec(cfg, gb // n_peers)
                out["encoder_out"] = meta((n_peers,) + tuple(e.shape),
                                          e.dtype)
            else:
                out["encoder_out"] = encoder_input_spec(cfg, gb)
        return out
    if shape.kind == "prefill":
        out = {"tokens": meta((gb, s), torch.int32)}
        if needs_encoder_input(cfg):
            out["encoder_out"] = encoder_input_spec(cfg, gb)
        return out
    return {"token": meta((gb,), torch.int32),
            "cache": T.cache_spec(cfg, gb, s),
            "index": meta((), torch.int32)}
