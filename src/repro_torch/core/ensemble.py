"""Baseline algorithms of Section VI-A.e.

Counterpart of ``repro/core/ensemble.py``:

* P2PEGASOSRW is the gossip simulation with variant='rw' (it equals
  sequential Pegasos per cycle count when failure-free).
* WB1 (Eq. 18): weighted bagging over N independent Pegasos models, each
  trained on an independent random sample stream, the *ideal* use of the N
  parallel updates a cycle.
* WB2 (Eq. 19): weighted bagging over min(2^t, N) models, since a gossip
  node has been influenced by only ~2^t models at cycle t.
* Sequential Pegasos: the single-model baseline of Table I.

The sample indices are the reference's ``jax.random`` draws bit for bit
(``repro_torch.random``). Every Pegasos step goes through
``repro_torch.kernels.ops.pegasos_update``: kernel #6 on CUDA tensors (on
the layout ``row_route`` picks), its plain version on CPU tensors. The
population takes one launch a cycle; the sequential chain one launch an
iteration at N = 1, so its speed is the host's cost of a launch. The
bagging reads results back only at its eval points; the chain reads each
block's indices to the host once and launches on views of their rows.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from repro_torch import random
from repro_torch.core.learners import LinearModel, init_model
from repro_torch.kernels import ops
from repro_torch.utils.device import resolve_device
from repro_torch.utils.metrics import mean_of_mask, weighted_vote_error


@dataclass
class BaggingResult:
    cycles: List[int]
    err_wb1: List[float]
    err_wb2: List[float]
    err_single: List[float]     # mean error of the individual models (≈ Pegasos)


def _mean_single_err(W, X_test, y_test) -> torch.Tensor:
    """Mean 0-1 error over the (m_test, N) table of single-model votes."""
    pred = torch.where(X_test @ W.T >= 0, 1.0, -1.0)
    return mean_of_mask(pred != y_test[:, None])


def _f32(dev, *arrays):
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in arrays)


def run_weighted_bagging(X, y, X_test, y_test, *, n_models: int,
                         cycles: int, lam: float = 1e-4, seed: int = 0,
                         eval_every: int = 10,
                         device=None) -> BaggingResult:
    """WB1, WB2 and the mean single-model error over ``cycles`` cycles of
    ``n_models`` Pegasos models, model i stepping on example ``idx[i]`` of
    the cycle's draw ``randint(sub, (n_models,), 0, n)``. Runs on the CUDA
    card unless ``device`` names another."""
    dev = resolve_device(device)
    n, d = X.shape
    key = random.key(seed, device=dev)
    W, t = init_model(d, n_models, device=dev)
    X, y, X_test, y_test = _f32(dev, X, y, X_test, y_test)

    res = BaggingResult([], [], [], [])
    for c in range(cycles):
        key, sub = random.split(key)
        idx = random.randint(sub, (n_models,), 0, n)
        # fresh contiguous rows, as the kernel's checks want
        W, t = ops.pegasos_update(W, t, X[idx], y[idx], lam=lam)
        if (c + 1) % eval_every == 0 or c == cycles - 1:
            res.cycles.append(c + 1)
            res.err_wb1.append(float(weighted_vote_error(W, X_test, y_test)))
            k = min(2 ** (c + 1), n_models)
            res.err_wb2.append(float(weighted_vote_error(W[:k], X_test,
                                                         y_test)))
            res.err_single.append(float(_mean_single_err(W, X_test, y_test)))
    return res


def run_sequential_pegasos(X, y, X_test, y_test, *, iters: int,
                           lam: float = 1e-4, seed: int = 0,
                           eval_every: int = 1000, device=None):
    """Table I's 'Pegasos 20,000 iter.' baseline: one model, a random
    stream, in blocks of ``eval_every`` iterations, each block's indices
    one ``randint(sub, (step,), 0, n)``. Returns the final
    :class:`LinearModel` ((d,) w) and the (iterations, 0-1 error) points.
    Runs on the CUDA card unless ``device`` names another."""
    dev = resolve_device(device)
    n, d = X.shape
    key = random.key(seed, device=dev)
    X, y, X_test, y_test = _f32(dev, X, y, X_test, y_test)
    # Rows padded to a multiple of four floats, so that the (1, d) view of
    # every row starts on a 16-byte boundary, as does y's (1,) view: each
    # iteration launches the step on views, with no gather.
    dp = -(-d // 4) * 4
    Xp = torch.zeros((n, dp), dtype=torch.float32, device=dev)
    Xp[:, :d] = X
    yp = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    yp[:, 0] = y
    w, t = init_model(d, 1, device=dev)

    points = []
    done = 0
    while done < iters:
        step = min(eval_every, iters - done)
        key, sub = random.split(key)
        for j in random.randint(sub, (step,), 0, n).tolist():
            w, t = ops.pegasos_update(w, t, Xp[j:j + 1, :d], yp[j:j + 1, 0],
                                      lam=lam)
        done += step
        pred = torch.where(X_test @ w[0] >= 0, 1.0, -1.0)
        points.append((done, float(mean_of_mask(pred != y_test))))
    return LinearModel(w[0], t[0]), points
