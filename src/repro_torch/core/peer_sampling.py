"""Peer sampling (Section III-c) on the port's threefry draws.

Counterpart of ``repro/core/peer_sampling.py``. ``uniform_peers`` and
``perfect_matching``: for a given key both return exactly the reference's
destinations. The deterministic partner schedules of the gossip optimizer
(``hypercube``, ``ring``, ``random``) are numpy copies of the reference's,
equal element for element: a schedule is host data, one permutation a
step."""
from __future__ import annotations

import numpy as np
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


def hypercube_partner(step: int, n: int):
    """partner = rank XOR 2^(step mod log2(n)). Requires n a power of two."""
    bits = int(np.log2(n))
    if 1 << bits != n:
        raise ValueError(f"hypercube needs power-of-two population, got {n}")
    return np.arange(n) ^ (1 << (step % bits))


def ring_partner(step: int, n: int):
    """Alternating ±1 ring neighbors."""
    shift = 1 if step % 2 == 0 else -1
    return (np.arange(n) + shift) % n


def random_permutation_partner(seed: int, step: int, n: int):
    """A pairing drawn from numpy's generator seeded with ``(seed, step)``
    (the closest to the paper's uniform sampling that is still a pairing
    fixed per step)."""
    rng = np.random.default_rng((seed, step))
    perm = rng.permutation(n)
    dst = np.empty(n, dtype=np.int64)
    a, b = perm[0::2], perm[1::2]
    dst[a], dst[b] = b, a
    return dst


def partner_schedule(kind: str, step: int, n: int, seed: int = 0):
    if kind == "hypercube":
        return hypercube_partner(step, n)
    if kind == "ring":
        return ring_partner(step, n)
    if kind == "random":
        return random_permutation_partner(seed, step, n)
    raise ValueError(f"unknown schedule {kind!r}")
