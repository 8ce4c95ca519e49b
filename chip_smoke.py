#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA GPU and
check it.

    python3 chip_smoke.py [--out results.json]

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a)
and ``nvcc``. The phases, each of which raises on failure:

0. setup: the card's name and power limit, torch/CUDA/nvcc versions, and
   the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``;
1. each kernel against its plain PyTorch version on the card, at the
   shapes of the paper's datasets (d = 10, 57, 9947) and a K > C case;
2. the sharded engine with the kernel against the port's reference engine
   on the card (N = 20 000, the paper's extreme scenario), and the first
   chunk's threefry draw tables made on the card against the CPU's;
3. the main path at full width: ``run_simulation(engine="sharded")`` at
   N = 10^6 nodes, d = 10, extreme scenario, MU, K = 4, cache 10, 20
   cycles; launches, curves, the message economy, wall time, node-cycles/s
   and peak memory, then each kernel's time per launch on the main path's
   own inputs beside its bound, its plain version's time and its agreement
   with the plain version there.

Prints one JSON line of per-kernel results, the ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``. Exits non-zero,
printing no result, without a CUDA device or outside a checkout.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
INT_FIELDS = ("last_t", "cache_t", "ptr", "count")
STATE = ("last_w", "last_t", "cache_w", "cache_t", "ptr", "count")
ORDER = STATE + ("msg_w", "msg_t", "valid", "x", "y")


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def receive_inputs(seed, n, d, c, k, device):
    """A mid-run state with a random valid mask, made with numpy."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    i = lambda lo, hi, *s: rng.integers(lo, hi, size=s, dtype=np.int32)
    arrs = dict(
        last_w=f(n, d), last_t=i(0, 40, n), cache_w=f(n, c, d),
        cache_t=i(0, 40, n, c), ptr=i(1, 3 * c, n), count=i(1, c + 1, n),
        msg_w=f(k, n, d) * 3, msg_t=i(0, 40, k, n),
        valid=(rng.random((k, n)) < 0.6).astype(np.int32), x=f(n, d),
        y=np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32))
    return {key: torch.from_numpy(v).to(device) for key, v in arrs.items()}


def compare_kernel(inputs, variant, lam, atol, rtol=1e-5):
    """Run the kernel and the plain version on copies of ``inputs`` on the
    card; integer state must be equal, float state within tolerance.
    Returns the max abs error over the float state."""
    import torch
    from repro_torch.kernels import gossip_cycle as gc
    a = {k: v.clone() for k, v in inputs.items()}
    b = {k: v.clone() for k, v in inputs.items()}
    gc.fused_receive_apply(*(a[k] for k in ORDER), variant=variant, lam=lam)
    gc.fused_receive_apply_plain(*(b[k] for k in ORDER), variant=variant,
                                 lam=lam)
    torch.cuda.synchronize()
    err = 0.0
    for k in STATE:
        if k in INT_FIELDS:
            if not torch.equal(a[k], b[k]):
                bad = int((a[k] != b[k]).sum())
                raise AssertionError(f"{variant}: {k} differs in {bad} "
                                     "entries")
        else:
            if not torch.isfinite(a[k]).all():
                raise AssertionError(f"{variant}: {k} not finite")
            err = max(err, float((a[k] - b[k]).abs().max()))
            if not torch.allclose(a[k], b[k], rtol=rtol, atol=atol):
                raise AssertionError(f"{variant}: {k} off by {err}")
    return err


def compare_engines(cfg, X, y, n: int, device, **kw):
    """Run the port's reference engine and its sharded engine (the kernel
    on the card) on the same inputs: the kernel must launch once a cycle,
    both economies add up and agree exactly, and the curves agree within
    0.02. Returns the sharded result and the max curve difference."""
    from repro_torch.core.simulation import run_simulation
    from repro_torch.kernels import gossip_cycle as gc
    args = (cfg, X[:n], y[:n], X[n:], y[n:])
    ref = run_simulation(*args, engine="reference", device=device, **kw)
    before = gc.fused_receive_apply.launches
    sh = run_simulation(*args, engine="sharded", device=device, **kw)
    launches = gc.fused_receive_apply.launches - before
    if launches != kw["cycles"]:
        raise AssertionError(f"sharded engine launched the kernel {launches} "
                             f"times in {kw['cycles']} cycles")
    econ = lambda r: (r.sent_total, r.delivered_total, r.lost_total,
                      r.overflow_total, r.in_flight_total,
                      list(r.delivered_per_cycle))
    for r in (ref, sh):
        if r.sent_total != (r.delivered_total + r.lost_total
                            + r.overflow_total + r.in_flight_total):
            raise AssertionError("message economy does not add up")
    if econ(ref) != econ(sh):
        raise AssertionError(f"economy differs: {econ(ref)[:5]} vs "
                             f"{econ(sh)[:5]}")
    if ref.cycles != sh.cycles:
        raise AssertionError("eval points differ")
    curve_diff = max(abs(a - b) for a, b in zip(
        ref.err_fresh + ref.err_voted, sh.err_fresh + sh.err_voted))
    if not curve_diff <= 0.02:
        raise AssertionError(f"curves differ by {curve_diff}")
    return sh, curve_diff


def receive_bound(valid, variant: str, d: int):
    """Least bytes and flops of one receive launch on these inputs: the
    valid lanes; per valid (node, round) the message row and counter read
    and one cache row and counter written; per node with a valid round its
    x, y, ptr, count, last_t read (last_w too for mu/um) and last_w,
    last_t, ptr, count written."""
    k, n = valid.shape
    v = int((valid > 0).sum())
    r = int(((valid > 0).sum(0) > 0).sum())
    nbytes = (4 * k * n + v * 2 * (4 * d + 4)
              + r * ((4 * d + 4) + (4 * d if variant != "rw" else 0)
                     + 4 * d + 3 * 4 + 3 * 4))
    per_elem = {"rw": 5, "mu": 7, "um": 12}[variant]    # merge, margin, step
    flops = v * per_elem * d
    ms_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(ms_bytes, ms_ops), "bytes" if ms_bytes >= ms_ops
            else "operations", nbytes)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measured number to this JSON file")
    opts = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch import random
    from repro_torch.configs.gossip_linear import (GossipLinearConfig,
                                                   with_failure_scenario)
    from repro_torch.core import sharded_engine as se
    from repro_torch.core.simulation import run_simulation
    from repro_torch.data.synthetic import make_linear_dataset
    from repro_torch.kernels import _build
    from repro_torch.kernels import gossip_cycle as gc

    dev = torch.device("cuda")
    card = smi()
    results = {"card": card}

    # ---- 0. setup ------------------------------------------------------
    nvcc_ver = subprocess.run([_build.nvcc(), "--version"],
                              capture_output=True, text=True, timeout=60,
                              check=True).stdout.strip().splitlines()[-1]
    print(f"[0] card: {card}")
    print(f"[0] torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"python {sys.version.split()[0]}, {nvcc_ver}")
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    print(f"[0] kernel build: {build_s:.2f} s "
          f"({', '.join(_build.SOURCES)})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[0]   {name}: {line.strip()}")
    results["build_s"] = build_s

    # ---- 1. kernel vs plain ------------------------------------------------
    max_err = 0.0
    shapes = [(4099, 10, 10, 4, 1e-5), (4099, 57, 10, 4, 1e-5),
              (2000, 9947, 10, 4, 1e-4), (257, 16, 3, 5, 1e-5)]
    for si, (n, d, c, k, atol) in enumerate(shapes):
        inputs = receive_inputs(si, n, d, c, k, dev)
        for variant in ("rw", "mu", "um"):
            err = compare_kernel(inputs, variant, 1e-3, atol)
            max_err = max(max_err, err)
            print(f"[1] fused_receive_apply N={n} d={d} C={c} K={k} "
                  f"{variant}: ints equal, max abs err {err:.3e} "
                  f"(atol {atol:g}, rtol 1e-5)")
        del inputs
    torch.cuda.empty_cache()

    # ---- 2. path vs oracle -------------------------------------------------
    n2 = 20_000
    rng = np.random.default_rng(0)
    X, y = make_linear_dataset(rng, n2 + 1000, 10, noise=0.07,
                               separation=2.5)
    cfg2 = with_failure_scenario(GossipLinearConfig(
        name="smoke-20k", dim=10, n_nodes=n2, n_test=1000,
        class_ratio=(1, 1), lam=1e-3, variant="mu", cache_size=10),
        "extreme")
    sh, curve_diff = compare_engines(cfg2, X, y, n2, dev, cycles=20,
                                     eval_every=10, seed=0, k_rounds=4)
    print(f"[2] N={n2} extreme 20 cycles: economy equal (sent "
          f"{sh.sent_total}, delivered {sh.delivered_total}, lost "
          f"{sh.lost_total}, overflow {sh.overflow_total}, in flight "
          f"{sh.in_flight_total}); max curve difference {curve_diff:.3e}; "
          f"err_fresh {sh.err_fresh} err_voted {sh.err_voted}")
    online = np.random.default_rng(1).random((10, n2)) < 0.9
    tables = []
    for d_ in (dev, torch.device("cpu")):
        keys = se.key_schedule(0, 10, d_)
        dst, arr = se._draw_chunk(keys, torch.as_tensor(online, device=d_),
                                  0, n=n2, drop=0.5, delay_max=10,
                                  sampler="uniform")
        tables.append((keys.cpu(), dst.cpu(), arr.cpu()))
    if not all(torch.equal(a, b) for a, b in zip(*tables)):
        raise AssertionError("draw tables differ between CUDA and CPU")
    perm = [random.permutation(random.key(3, device=d_), 1001).cpu()
            for d_ in (dev, torch.device("cpu"))]
    if not torch.equal(*perm):
        raise AssertionError("permutation differs between CUDA and CPU")
    print("[2] first chunk's key schedule and draw tables (and a "
          "permutation) bitwise equal on CUDA and CPU")
    results["phase2"] = dict(curve_diff=curve_diff, sent=sh.sent_total,
                             err_fresh=sh.err_fresh, err_voted=sh.err_voted)

    # ---- 3. full size ------------------------------------------------------
    n3, cycles = 1_000_000, 20
    rng = np.random.default_rng(0)
    X, y = make_linear_dataset(rng, n3 + 1000, 10, noise=0.07,
                               separation=2.5)
    cfg3 = with_failure_scenario(GossipLinearConfig(
        name=f"million-{n3}", dim=10, n_nodes=n3, n_test=1000,
        class_ratio=(1, 1), lam=1e-3, variant="mu", cache_size=10),
        "extreme")

    captured = {}
    kernel = gc.fused_receive_apply

    def capture_last(*a, **kw_):
        # keep a copy of the main path's last launch inputs for timing
        if kernel.launches == cycles - 1:
            captured.update({k: v.clone() for k, v in zip(ORDER, a)})
        return kernel(*a, **kw_)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gc.fused_receive_apply = capture_last
    try:
        kernel.launches = 0
        t0 = time.perf_counter()
        res = run_simulation(cfg3, X[:n3], y[:n3], X[n3:], y[n3:],
                             engine="sharded", cycles=cycles, eval_every=10,
                             seed=0, k_rounds=4, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel.launches
    finally:
        gc.fused_receive_apply = kernel
    peak = torch.cuda.max_memory_allocated()
    if launches != cycles:
        raise AssertionError(f"main path launched the kernel {launches} "
                             f"times, expected {cycles}")
    if res.sent_total != (res.delivered_total + res.lost_total
                          + res.overflow_total + res.in_flight_total):
        raise AssertionError("message economy does not add up")
    curves = res.err_fresh + res.err_voted + res.similarity
    if not (len(res.cycles) == 2 and all(np.isfinite(curves))
            and all(0.0 <= e <= 0.5 for e in res.err_fresh + res.err_voted)):
        raise AssertionError(f"bad curves {curves}")
    rate = n3 * cycles / wall
    print(f"[3] {card}: N={n3} d=10 extreme MU K=4 C=10 {cycles} cycles: "
          f"launches {launches}; cycles {res.cycles} err_fresh "
          f"{res.err_fresh} err_voted {res.err_voted} similarity "
          f"{res.similarity}")
    print(f"[3] {card}: economy sent {res.sent_total} = delivered "
          f"{res.delivered_total} + lost {res.lost_total} + overflow "
          f"{res.overflow_total} + in flight {res.in_flight_total}")
    print(f"[3] {card}: wall {wall:.3f} s, {rate:.0f} node-cycles/s, "
          f"peak device memory {peak / 2**30:.2f} GiB")

    # the kernel on the main path's own last-launch inputs
    err3 = compare_kernel(captured, cfg3.variant, cfg3.lam, 1e-5)
    max_err = max(max_err, err3)
    state = {k: v.clone() for k, v in captured.items()}
    kargs = [state[k] for k in ORDER]
    ms = cuda_time_ms(lambda: kernel(*kargs, variant=cfg3.variant,
                                     lam=cfg3.lam), reps=20)
    pstate = {k: v.clone() for k, v in captured.items()}
    pargs = [pstate[k] for k in ORDER]
    plain_ms = cuda_time_ms(lambda: gc.fused_receive_apply_plain(
        *pargs, variant=cfg3.variant, lam=cfg3.lam), reps=5, warmup=1)
    bound_ms, bound_by, nbytes = receive_bound(captured["valid"],
                                               cfg3.variant, 10)
    print(f"[3] {card}: fused_receive_apply at N={n3} d=10 C=10 K=4 mu: "
          f"{ms:.4f} ms/launch vs bound {bound_ms:.4f} ms ({bound_by}, "
          f"{nbytes} B); plain version {plain_ms:.4f} ms; max abs err vs "
          f"plain {err3:.3e}")
    results["phase3"] = dict(
        n=n3, cycles=cycles, wall_s=wall, node_cycles_per_s=rate,
        peak_bytes=peak, launches=launches, err_fresh=res.err_fresh,
        err_voted=res.err_voted, sent=res.sent_total,
        delivered=res.delivered_total, lost=res.lost_total,
        overflow=res.overflow_total, in_flight=res.in_flight_total,
        kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_bytes=nbytes)

    # where the time goes: the same run again under the profiler
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_simulation(cfg3, X[:n3], y[:n3], X[n3:], y[n3:],
                       engine="sharded", cycles=cycles, eval_every=10,
                       seed=0, k_rounds=4, device="cuda")
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)
    # device-side events only (kernels, copies): an op's own device time
    # repeats its kernels'
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA), key=dev_us,
                    reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = [(e.key, dev_us(e) / 1e3, e.count) for e in events[:8]
           if dev_us(e) > 0]
    print(f"[3] {card}: profiled rerun wall {pwall:.3f} s, device busy "
          f"{busy_ms:.1f} ms ({busy_ms / 1e3 / pwall:.2%}), idle share "
          f"{1 - busy_ms / 1e3 / pwall:.2%}")
    for key, t_ms, count in top:
        print(f"[3]   {t_ms:9.3f} ms  x{count:<6d} {key[:90]}")
    results["profile"] = dict(wall_s=pwall, device_busy_ms=busy_ms,
                              top=[dict(name=k, ms=t, count=c)
                                   for k, t, c in top])

    kernels = [dict(
        name="fused_receive_apply", route="cuda",
        source="src/repro_torch/kernels/csrc/gossip_cycle.cu",
        replaces="src/repro/kernels/gossip_cycle.py:204",
        launches=launches, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)]
    results["kernels"] = kernels
    if opts.out:
        out = Path(opts.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
