"""Surrogate datasets matching the paper's Table I geometries (numpy).

A copy of ``repro/data/synthetic.py``: the same generator consuming the
same ``numpy`` stream, so a seed gives bitwise-equal data in both packages
(``tests/test_torch_core.py``)."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.configs.gossip_linear import DATASETS, GossipLinearConfig


def make_linear_dataset(rng: np.random.Generator, n: int, d: int,
                        *, noise: float = 0.1, sparsity: float = 0.0,
                        class_ratio: Tuple[int, int] = (1, 1),
                        separation: float = 3.0):
    """Gaussian class-conditional data with a controlled Bayes floor.

    X = noise_cloud + (separation/√d)·y·w_true, then a ``noise`` label-flip;
    ``sparsity`` zeroes feature entries (Reuters-like bag-of-words)."""
    w_true = rng.normal(size=d)
    w_true /= np.linalg.norm(w_true)
    X = rng.normal(size=(n, d)).astype(np.float32) / np.sqrt(d)
    if sparsity > 0:
        mask = rng.random((n, d)) >= sparsity
        X = (X * mask / np.sqrt(max(1.0 - sparsity, 1e-6))).astype(np.float32)
    pos, neg = class_ratio
    y = np.where(rng.random(n) < pos / (pos + neg), 1.0, -1.0).astype(np.float32)
    X = (X + (separation / np.sqrt(d)) * y[:, None] * w_true[None, :]).astype(np.float32)
    flip = rng.random(n) < noise
    y[flip] = -y[flip]
    return X, y


_PAPER_NOISE = {
    "reuters": dict(noise=0.02, sparsity=0.9, separation=4.0),
    "spambase": dict(noise=0.10, sparsity=0.0, separation=2.5),
    "malicious-urls": dict(noise=0.07, sparsity=0.0, separation=2.5),
}


def paper_dataset(name: str, seed: int = 0):
    """(X_train, y_train, X_test, y_test, cfg) for a Table I surrogate."""
    cfg: GossipLinearConfig = DATASETS[name]
    rng = np.random.default_rng(seed)
    kw = _PAPER_NOISE[name]
    X, y = make_linear_dataset(rng, cfg.n_nodes + cfg.n_test, cfg.dim,
                               class_ratio=cfg.class_ratio, **kw)
    return (X[:cfg.n_nodes], y[:cfg.n_nodes],
            X[cfg.n_nodes:], y[cfg.n_nodes:], cfg)
