"""Peer sampling (Section III-c) on the port's threefry draws.

Counterpart of ``repro/core/peer_sampling.py``'s ``uniform_peers`` and
``perfect_matching``: for a given key both return exactly the reference's
destinations."""
from __future__ import annotations

import torch

from repro_torch import random


def uniform_peers(key, n: int) -> torch.Tensor:
    """dst[i] ~ Uniform({0..n-1} \\ {i}) as (n,) int32."""
    r = random.randint(key, (n,), 0, n - 1)
    idx = torch.arange(n, device=r.device)
    return torch.where(r >= idx, r + 1, r)


def perfect_matching(key, n: int) -> torch.Tensor:
    """Random involution: consecutive elements of a random permutation are
    paired; odd N leaves the last one mapped to itself (idle this cycle)."""
    perm = random.permutation(key, n)
    m = n - (n % 2)
    a, b = perm[0:m:2], perm[1:m:2]
    dst = torch.arange(n, dtype=torch.int32, device=perm.device)
    dst[a] = b.to(torch.int32)
    dst[b] = a.to(torch.int32)
    return dst
