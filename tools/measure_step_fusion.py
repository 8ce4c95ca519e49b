#!/usr/bin/env python
"""Measure how XLA on the CPU fuses the learner step under ``jax.jit``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/measure_step_fusion.py
        [--widths 8,10,16,57] [--nodes 13,1000,20000] [--quick]

Runs the JAX package's jitted ``sharded_engine._vector_apply`` and
``simulation.apply_receives`` (K = 5 rounds, cache 3, so K > C) on seeded
random inputs for Pegasos, Adaline and logistic regression, each
CREATEMODEL variant and each defense, and the port's counterparts on the
same inputs: ``sharded_engine._vector_apply`` and
``simulation.apply_receives`` with the learner's step in the eager order
(``learners.make_update``) and in the jitted order
(``make_update(..., fused=True)``: the products that feed one add fused,
XLA's Cephes ``exp`` in the sigmoid; for Pegasos, which the engine applies
with the receive kernel and not with the vector apply, this tool's own
``pegasos_update_fused``). Prints, per case, the nodes whose
cache rows differ in any bit and the largest absolute difference of the
cached weights under each order, and checks that every integer output
(counters, ring pointers, screen counts) and lastModel are equal.

The step's own rules are the module note of ``repro_torch/core/learners.py``
and, for Pegasos, ``pegasos_update_fused`` below: ``decay = fma(-eta, lam,
1)``, ``w' = fma(decay, w, sel)`` with ``sel = where(margin < 1, eta (y x),
0)`` rounded; under it Pegasos is bit for bit the jitted reference but
under ``mu`` with norm_clip (and in one other case of the full sweep).
Where a case stays apart under the jitted order, XLA fused a product of the
merge (``(w1 + w2) / 2``) or of norm_clip's rescale into the step: LLVM
unswitches the loop on the clip flag and sinks the last coefficient's add
past the branch, so which product an add fuses with depends on the fusion's
shape, not on the arithmetic alone."""
from __future__ import annotations

import argparse
import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.core import sharded_engine as jse
from repro.core import simulation as jsim
from repro.core.cache import ModelCache as JCache
from repro.core.learners import make_update as jax_make_update
from repro_torch.core import faults
from repro_torch.core import sharded_engine as pse
from repro_torch.core import simulation as psim
from repro_torch.core.cache import ModelCache
from repro_torch.core.learners import LinearModel, make_update

LAM, ETA, K, C = 1e-3, 0.01, 5, 3
LEARNERS = ("pegasos", "adaline", "logistic")
VARIANTS = ("rw", "mu", "um")
DEFENSES = ("none", "norm_clip", "cosine_gate")


def inputs(n: int, d: int, defense: str, seed: int = 0):
    """Seeded random state, messages and records (K rounds, cache C);
    norm_clip's messages are scaled up so that it clips."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    i = lambda lo, hi, *s: rng.integers(lo, hi, size=s).astype(np.int32)
    return dict(last_w=f(n, d) * 0.3, last_t=i(1, 40, n), fresh_w=f(n, d),
                fresh_t=i(1, 40, n), cw=f(n, C, d), ct=i(0, 40, n, C),
                ptr=i(1, 3 * C, n), cnt=i(1, C + 1, n),
                msg_w=f(K, n, d) * (3.0 if defense == "norm_clip" else 1.0),
                msg_t=i(1, 40, K, n), valid=rng.random((K, n)) < 0.8,
                x=f(n, d),
                y=np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32))


def pegasos_update_fused(m: LinearModel, x, y, lam: float) -> LinearModel:
    """Pegasos' step of (N, d) models in the jitted order."""
    t = m.t + 1
    eta = 1.0 / (lam * t.to(torch.float32))
    margin = y * faults._screen_sum(m.w, x, 2)
    decay = faults._fma(-eta, torch.full_like(eta, lam),
                        torch.ones_like(eta))
    sel = torch.where((margin < 1.0)[..., None],
                      eta[..., None] * (y[..., None] * x), 0.0)
    return LinearModel(faults._fma(decay[..., None].expand_as(m.w), m.w,
                                   sel), t)


def port_update(learner: str, fused: bool):
    """The port's step of ``learner``, in the eager or the jitted order."""
    if fused and learner == "pegasos":
        return lambda m, x, y: pegasos_update_fused(m, x, y, LAM)
    return make_update(learner, lam=LAM, eta=ETA, fused=fused)


def run_jax(fn_name, a, learner, variant, defense):
    J = {k: jnp.asarray(v) for k, v in a.items()}
    cache = JCache(J["cw"], J["ct"], J["ptr"], J["cnt"])
    upd = jax_make_update(learner, lam=LAM, eta=ETA)
    if fn_name == "vector_apply":
        fn = jax.jit(functools.partial(jse._vector_apply, variant=variant,
                                       update=upd, defense=defense))
        o = fn(J["last_w"], J["last_t"], J["fresh_w"], J["fresh_t"], cache,
               J["msg_w"], J["msg_t"], J["valid"], J["x"], J["y"])
        lw, lt, c2, g, cl = o[0], o[1], o[4], o[5], o[6]
    else:
        fn = jax.jit(functools.partial(jsim.apply_receives, variant=variant,
                                       update=upd, defense=defense))
        lw, lt, c2, g, cl = fn(J["last_w"], J["last_t"], cache, J["msg_w"],
                               J["msg_t"], J["valid"], J["x"], J["y"])
    return [np.asarray(v) for v in (lw, lt, c2.w, c2.t, c2.ptr, c2.count,
                                    g, cl)]


def flat_rows(update):
    """A step over (N, d) rows applied to the vector apply's (K, N, d)
    batch, row by row."""
    def step(m, x, y):
        d = m.w.shape[-1]
        out = update(LinearModel(m.w.reshape(-1, d), m.t.reshape(-1)),
                     x.reshape(-1, d), y.reshape(-1))
        return LinearModel(out.w.reshape(m.w.shape), out.t.reshape(m.t.shape))
    return step


def run_port(fn_name, a, learner, variant, defense, fused):
    T = {k: torch.from_numpy(v) for k, v in a.items()}
    cache = ModelCache(T["cw"], T["ct"], T["ptr"], T["cnt"])
    upd = port_update(learner, fused)
    if fn_name == "vector_apply" and not fused:
        upd = flat_rows(upd)
    if fn_name == "vector_apply":
        o = pse._vector_apply(T["last_w"], T["last_t"], T["fresh_w"],
                              T["fresh_t"], cache, T["msg_w"], T["msg_t"],
                              T["valid"], T["x"], T["y"], variant=variant,
                              update=upd, defense=defense)
        lw, lt, c2, g, cl = o[0], o[1], o[4], o[5], o[6]
    else:
        lw, lt, c2, g, cl = psim.apply_receives(
            T["last_w"], T["last_t"], cache, T["msg_w"], T["msg_t"],
            T["valid"], T["x"], T["y"], variant=variant, update=upd,
            defense=defense)
    return [v.numpy() for v in (lw, lt, c2.w, c2.t, c2.ptr, c2.count, g,
                                cl)]


def compare(want, got):
    """(rows whose cache weights differ in any bit, max abs difference,
    whether lastModel and every integer output are equal)."""
    cw_w, cw_g = want[2], got[2]
    rows = int((cw_w.view(np.int32) != cw_g.view(np.int32)).any(
        axis=(1, 2)).sum())
    err = float(np.abs(cw_w.astype(np.float64) - cw_g).max())
    exact = np.array_equal(want[0].view(np.int32), got[0].view(np.int32))
    exact &= all(np.array_equal(a, b) for a, b in zip(want[3:], got[3:]))
    exact &= np.array_equal(want[1], got[1])
    return rows, err, exact


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", default="8,10,16,57")
    ap.add_argument("--nodes", default="13,1000,20000")
    ap.add_argument("--quick", action="store_true",
                    help="d = 10, N = 1000, vector apply only")
    args = ap.parse_args()
    widths = [10] if args.quick else [int(v) for v in args.widths.split(",")]
    nodes = [1000] if args.quick else [int(v) for v in args.nodes.split(",")]
    fns = ("vector_apply",) if args.quick else ("vector_apply",
                                                "apply_receives")
    print("fn,learner,variant,defense,d,N,rows_eager,max_eager,"
          "rows_fused,max_fused,ints_and_last_equal")
    worst = {}
    for fn_name in fns:
        for learner in LEARNERS:
            for variant in VARIANTS:
                for defense in DEFENSES:
                    for d in widths:
                        for n in nodes:
                            a = inputs(n, d, defense)
                            want = run_jax(fn_name, a, learner, variant,
                                           defense)
                            re, ee, _ = compare(want, run_port(
                                fn_name, a, learner, variant, defense,
                                False))
                            rf, ef, ok = compare(want, run_port(
                                fn_name, a, learner, variant, defense,
                                True))
                            print(f"{fn_name},{learner},{variant},{defense},"
                                  f"{d},{n},{re},{ee:.3e},{rf},{ef:.3e},"
                                  f"{ok}", flush=True)
                            key = (fn_name, learner)
                            worst[key] = max(worst.get(key, 0.0), ef)
    for (fn_name, learner), err in sorted(worst.items()):
        print(f"max_fused,{fn_name},{learner},{err:.3e}")


if __name__ == "__main__":
    main()
