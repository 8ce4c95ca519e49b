"""Theorem 1 validation: the P2PegasosMU regret bound.

Counterpart of ``repro/core/theory.py``:

    (1/t) Σ_i [ f_i(w̄^(i)) − f_i(w*) ]  ≤  G² (log t + 1) / (2 λ t)

where the sequence w^(0..t) follows the *worst ancestor* path of the merge
DAG (Eq. 11), w̄^(i) is the pre-update average of the two ancestors, and
f_i is the λ-strong instantaneous objective (Eq. 10) for the example used
at step i.

A small exact MU chain records (w̄, example) along the worst-ancestor path
at every merge-update, computes f_i(w̄^(i)) − f_i(w*) with w* from
full-batch subgradient descent on f (Eq. 9) on the device, and compares
the running average with the bound. G is sup‖∇‖ ≤ λ‖w‖ + max‖x‖, bounded
with the Pegasos ball ‖w‖ ≤ 1/√λ · max‖x‖ (Shalev-Shwartz et al.).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from repro_torch.core.learners import init_model, make_update
from repro_torch.core.merge import merge
from repro_torch.utils.device import resolve_device


def svm_objective(w, X, y, lam: float) -> torch.Tensor:
    """f(w) of Eq. (9): λ/2 ‖w‖² + mean hinge loss."""
    hinge = torch.clamp_min(1.0 - y * (X @ w), 0.0)
    return lam / 2.0 * torch.dot(w, w) + torch.mean(hinge)


def f_i(w, x, y, lam: float) -> torch.Tensor:
    """The instantaneous objective of Eq. (10)."""
    return (lam / 2.0 * torch.dot(w, w)
            + torch.clamp_min(1.0 - y * torch.dot(w, x), 0.0))


def solve_w_star(X, y, lam: float, iters: int = 4000, lr0: float = 1.0,
                 device=None) -> torch.Tensor:
    """Full-batch Pegasos-style subgradient descent to the global optimum
    of the λ-strongly-convex objective (deterministic; the better of the
    last and the averaged iterate), ``iters`` steps on the CUDA card unless
    ``device`` names another. ``lr0`` is the reference's unused argument."""
    del lr0
    dev = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    w = torch.zeros(X.shape[1], dtype=torch.float32, device=dev)
    wsum = torch.zeros_like(w)
    yX = y[:, None] * X
    for t in range(iters):
        # eta = 1 / (lam (t + 1)) in float32, as the reference's scan
        # computes it from its float32 step counter
        eta = float(np.float32(1.0) / (np.float32(lam)
                                       * (np.float32(t) + np.float32(1.0))))
        margin = y * (X @ w)
        g = lam * w - torch.mean(
            torch.where(margin < 1.0, 1.0, 0.0)[:, None] * yX, dim=0)
        w = w - eta * g
        wsum = wsum + w
    w_avg = wsum / iters
    # take the better of last / averaged iterate
    if svm_objective(w, X, y, lam) < svm_objective(w_avg, X, y, lam):
        return w
    return w_avg


@dataclass
class RegretTrace:
    t: List[int]
    avg_regret: List[float]
    bound: List[float]
    holds: bool


def mu_chain_regret(X, y, lam: float, steps: int, seed: int = 0,
                    device=None) -> RegretTrace:
    """Follow one model along an MU merge chain and track Theorem 1's
    bound, on the CUDA card unless ``device`` names another.

    At step i the model merges with an independently-evolved partner model
    (the other ancestor, kept deliberately *worse* by giving it fewer
    updates, which realizes the worst-ancestor path of Eq. 11) and is
    updated with a uniformly sampled example (x_i, y_i), drawn from
    ``numpy.random.default_rng(seed)`` as the reference draws it."""
    dev = resolve_device(device)
    n, d = X.shape
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(seed)
    upd = make_update("pegasos", lam=lam)

    w_star = solve_w_star(X, y, lam, device=dev)
    max_x = float(torch.max(torch.linalg.vector_norm(X, dim=1)))
    G = lam * (max_x / np.sqrt(lam)) + max_x          # ‖∇f_i‖ ≤ λ‖w‖ + ‖x‖

    main = partner = init_model(d, device=dev)

    trace = RegretTrace([], [], [], True)
    total = 0.0
    for i in range(1, steps + 1):
        wbar_model = merge(main, partner)
        idx = int(rng.integers(0, n))
        xi, yi = X[idx], y[idx]
        total += float(f_i(wbar_model.w, xi, yi, lam)
                       - f_i(w_star, xi, yi, lam))
        main = upd(wbar_model, xi, yi)
        # the partner receives an update only every other step, so it stays
        # the "further-from-w*" ancestor, as in the worst-ancestor
        # construction
        if i % 2 == 0:
            jdx = int(rng.integers(0, n))
            partner = upd(partner, X[jdx], y[jdx])
        avg = total / i
        bound = G ** 2 * (np.log(i) + 1.0) / (2.0 * lam * i)
        trace.t.append(i)
        trace.avg_regret.append(avg)
        trace.bound.append(bound)
    trace.holds = all(r <= b + 1e-6
                      for r, b in zip(trace.avg_regret, trace.bound))
    return trace
