"""State carried across between the JAX package and the port.

The reference's sharded chunk function carries a 14-tuple
(``repro/core/sharded_engine.py``, the carry built in
``run_sharded_simulation``): ``last_w, last_t, fresh_w, fresh_t, cache.w,
cache.t, cache.ptr, cache.count, buf_w, buf_t, buf_scale, buf_zp, ef,
clock``. For the float32 wire the scale, zero-point and error-feedback
lanes are empty (0, 0) arrays. These helpers move that carry, as numpy
arrays, into the port's :class:`~repro_torch.core.sharded_engine.Carry` and
back, and rebuild a config from ``dataclasses.asdict`` of the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.configs.gossip_linear import GossipLinearConfig
from repro_torch.core.cache import ModelCache
from repro_torch.core.sharded_engine import Carry

CARRY_FIELDS = ("last_w", "last_t", "fresh_w", "fresh_t", "cache_w",
                "cache_t", "ptr", "count", "buf_w", "buf_t", "buf_scale",
                "buf_zp", "ef", "clock")
_FLOAT = {"last_w", "fresh_w", "cache_w", "buf_w"}


def state_from_arrays(arrays: Sequence, device) -> Carry:
    """The reference chunk carry (14 arrays in ``CARRY_FIELDS`` order) as
    the port's tensors on ``device``. Non-empty scale, zero-point or
    error-feedback lanes belong to the quantized wire codecs, which the
    port does not run yet, and raise."""
    if len(arrays) != len(CARRY_FIELDS):
        raise ValueError(f"expected {len(CARRY_FIELDS)} carry arrays "
                         f"({', '.join(CARRY_FIELDS)}), got {len(arrays)}")
    a = {k: np.asarray(v) for k, v in zip(CARRY_FIELDS, arrays)}
    for lane in ("buf_scale", "buf_zp", "ef"):
        if a[lane].size:
            raise NotImplementedError(
                f"non-empty {lane}: quantized wire codecs are ROADMAP.md "
                "queue 1 item 4")
    t = {k: torch.tensor(a[k], dtype=torch.float32 if k in _FLOAT
                         else torch.int32, device=device)
         for k in CARRY_FIELDS[:10]}
    return Carry(t["last_w"], t["last_t"], t["fresh_w"], t["fresh_t"],
                 ModelCache(t["cache_w"], t["cache_t"], t["ptr"],
                            t["count"]),
                 t["buf_w"], t["buf_t"], int(a["clock"]))


def to_arrays(carry: Carry) -> tuple:
    """The port's carry as the reference's 14-tuple of numpy arrays."""
    np_ = lambda x: x.detach().cpu().numpy()
    empty16 = np.zeros((0, 0), np.float16)
    return (np_(carry.last_w), np_(carry.last_t), np_(carry.fresh_w),
            np_(carry.fresh_t), np_(carry.cache.w), np_(carry.cache.t),
            np_(carry.cache.ptr), np_(carry.cache.count), np_(carry.buf_w),
            np_(carry.buf_t), empty16, empty16.copy(),
            np.zeros((0, 0), np.float32), np.asarray(carry.clock, np.int32))


def config_from_dict(d: Mapping) -> GossipLinearConfig:
    """The port's config from ``dataclasses.asdict`` of the reference's."""
    known = {f.name for f in dataclasses.fields(GossipLinearConfig)}
    bad = sorted(set(d) - known)
    if bad:
        raise ValueError(f"unknown GossipLinearConfig field(s) {bad}")
    kw = dict(d)
    if "class_ratio" in kw:
        kw["class_ratio"] = tuple(kw["class_ratio"])
    return GossipLinearConfig(**kw)
