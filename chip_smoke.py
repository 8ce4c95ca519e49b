#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA GPU and
check it.

    python3 chip_smoke.py [--out results.json]

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a)
and ``nvcc``. The phases, each of which raises on failure:

0. setup: the card's name and power limit, torch/CUDA/nvcc versions, and
   the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``;
1. each kernel against its plain PyTorch version on the card, at the
   shapes of the paper's datasets (d = 10, 57, 9947) and a K > C case: the
   receive kernel on the f32 wire and in every decode mode (bf16, f16,
   affine int8, int4, ternary), and the send kernels for int8, int8_sr,
   int4, int4_ef, ternary and ternary_ef (bitwise);
2. the sharded engine with the kernels against the port's reference engine
   on the card (N = 20 000, the paper's extreme scenario) on the f32 wire
   and on int8_sr, int4_ef and ternary, and the first chunk's threefry draw
   tables made on the card against the CPU's;
3. the main path at full width: ``run_simulation(engine="sharded")`` at
   N = 10^6 nodes, d = 10, extreme scenario, MU, K = 4, cache 10, 20
   cycles; launches, curves, the message economy, wall time, node-cycles/s
   and peak memory, then the receive kernel's time per launch on the main
   path's own inputs beside its bound, its plain version's time and its
   agreement with the plain version there, and a profiled rerun;
4. the same path on the quantized wire (int8_sr, int4_ef, ternary): for
   each, 20 receive and 20 send launches, the economy, the wire and buffer
   bytes against f32's, wall time, peak memory, and each kernel's time per
   launch on the path's own last-launch inputs beside its bound and its
   plain version's time, and a profiled rerun.

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
# H100 SXM float32 outside the tensor cores; the integer work of the
# threefry noise is counted at this rate too (the least time it could take)
F32_FLOPS_PER_S = 67e12
INT_FIELDS = ("last_t", "cache_t", "ptr", "count")
STATE = ("last_w", "last_t", "cache_w", "cache_t", "ptr", "count")
ORDER = STATE + ("msg_w", "msg_t", "valid", "x", "y")
META = ("msg_scale", "msg_zp")
# the receive kernel's decode modes, each with a codec that selects it
DECODE_WIRES = {"bf16": "bf16", "f16": "f16", "affine8": "int8",
                "int4": "int4", "ternary": "ternary"}
SEND_CODECS = ("int8", "int8_sr", "int4", "int4_ef", "ternary", "ternary_ef")
MAIN_WIRES = ("int8_sr", "int4_ef", "ternary")
# rows #2-#4 of the TPU-kernel table in PERF.md: each send kernel and the
# Pallas call it replaces (phase 4 drives them with MAIN_WIRES in order)
SEND_ROWS = {
    "affine8": "src/repro/kernels/gossip_cycle.py:422",
    "packed_ef": "src/repro/kernels/gossip_cycle.py:446",
    "packed": "src/repro/kernels/gossip_cycle.py:457",
}


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


def receive_inputs(seed, n, d, c, k, device, wire=None):
    """A mid-run state with a random valid mask, made with numpy. With
    ``wire``, the messages are that codec's payload (encoded by the port's
    plain codec on ``device``), with ``msg_scale``/``msg_zp`` where the
    codec carries them."""
    import numpy as np
    import torch
    from repro_torch.core.wire_codec import get_codec
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    i = lambda lo, hi, *s: rng.integers(lo, hi, size=s, dtype=np.int32)
    arrs = dict(
        last_w=f(n, d), last_t=i(0, 40, n), cache_w=f(n, c, d),
        cache_t=i(0, 40, n, c), ptr=i(1, 3 * c, n), count=i(1, c + 1, n),
        msg_w=f(k, n, d) * 3, msg_t=i(0, 40, k, n),
        valid=(rng.random((k, n)) < 0.6).astype(np.int32), x=f(n, d),
        y=np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32))
    out = {key: torch.from_numpy(v).to(device) for key, v in arrs.items()}
    if wire is not None:
        q, sc, zp = get_codec(wire).encode(out["msg_w"])
        out["msg_w"] = q
        out.update({k_: v for k_, v in zip(META, (sc, zp)) if v is not None})
    return out


def compare_kernel(inputs, variant, lam, atol, rtol=1e-5, wire=None):
    """Run the kernel and the plain version on copies of ``inputs`` on the
    card; integer state must be equal, float state within tolerance.
    Returns the max abs error over the float state."""
    import torch
    from repro_torch.kernels import gossip_cycle as gc
    a = {k: v.clone() for k, v in inputs.items()}
    b = {k: v.clone() for k, v in inputs.items()}
    kw = dict(variant=variant, lam=lam, wire=wire)
    gc.fused_receive_apply(*(a[k] for k in ORDER),
                           **{k: a[k] for k in META if k in a}, **kw)
    gc.fused_receive_apply_plain(*(b[k] for k in ORDER),
                                 **{k: b[k] for k in META if k in b}, **kw)
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


def send_inputs(seed, n, d, device):
    """(N, d) fresh models and an EF residual, made with numpy, with rows
    that reach the codecs' edge cases: all zero (scale 0), constant, codes
    on .5 ties, a saturating f16 scale and f16-subnormal scales."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, d), dtype=np.float32) * 3
    w[0] = 0.0
    w[1] = 0.75
    w[2] = np.round(w[2] * 2) / 2
    w[3] *= 1e5
    w[4] *= 1e-6
    ef = rng.standard_normal((n, d), dtype=np.float32) * 0.2
    return torch.from_numpy(w).to(device), torch.from_numpy(ef).to(device)


def compare_send(name, w, ef, key):
    """Run the send kernel and its plain version on the card on the same
    inputs; every output (codes or packed bytes, scale, zero-point,
    residual) must be equal bit for bit. Returns the outputs' names."""
    import torch
    from repro_torch.core.wire_codec import get_codec
    from repro_torch.kernels import gossip_cycle as gc
    codec = get_codec(name)
    kw = dict(key=key if codec.stochastic else None,
              ef=ef if codec.ef else None)
    got = gc.quantize_send(w, name, **kw)
    want = gc.quantize_send_plain(w, name, **kw)
    torch.cuda.synchronize()
    names = (("q", "scale", "zp") if codec.has_zp
             else ("payload", "scale", "resid")[:len(want)])
    for label, g, p in zip(names, got, want):
        if g.dtype != p.dtype or g.shape != p.shape:
            raise AssertionError(f"{name}: {label} is {g.dtype} "
                                 f"{tuple(g.shape)}, plain {p.dtype} "
                                 f"{tuple(p.shape)}")
        if not torch.equal(g.contiguous().view(torch.uint8),
                           p.contiguous().view(torch.uint8)):
            bad = int((g != p).sum())
            raise AssertionError(f"{name}: {label} differs from the plain "
                                 f"version in {bad} entries")
    return names


def compare_engines(cfg, X, y, n: int, device, **kw):
    """Run the port's reference engine and its sharded engine (the kernels
    on the card) on the same inputs: the receive kernel, and on a quantized
    wire the codec's send kernel, must launch once a cycle; both economies
    add up and agree exactly, the wire and buffer bytes agree, the curves
    agree within 0.02 and the EF residual norms within rtol 1e-4. Returns
    the sharded result and the max curve difference."""
    from repro_torch.core.simulation import run_simulation
    from repro_torch.core.wire_codec import get_codec
    from repro_torch.kernels import gossip_cycle as gc
    codec = get_codec(cfg.wire_dtype)
    args = (cfg, X[:n], y[:n], X[n:], y[n:])
    ref = run_simulation(*args, engine="reference", device=device, **kw)
    before = gc.fused_receive_apply.launches
    sends = dict(gc.quantize_send.launches)
    sh = run_simulation(*args, engine="sharded", device=device, **kw)
    launches = gc.fused_receive_apply.launches - before
    if launches != kw["cycles"]:
        raise AssertionError(f"sharded engine launched the kernel {launches} "
                             f"times in {kw['cycles']} cycles")
    if codec.quantized:
        kernel = gc.send_kernel_name(codec.name)
        sent = gc.quantize_send.launches[kernel] - sends[kernel]
        if sent != kw["cycles"]:
            raise AssertionError(f"sharded engine launched the {kernel} send "
                                 f"kernel {sent} times in {kw['cycles']} "
                                 "cycles")
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
    if (ref.wire_bytes_total, ref.buf_payload_bytes) != (
            sh.wire_bytes_total, sh.buf_payload_bytes):
        raise AssertionError("wire or buffer bytes differ")
    if ref.cycles != sh.cycles:
        raise AssertionError("eval points differ")
    curve_diff = max(abs(a - b) for a, b in zip(
        ref.err_fresh + ref.err_voted, sh.err_fresh + sh.err_voted))
    if not curve_diff <= 0.02:
        raise AssertionError(f"curves differ by {curve_diff}")
    ef_ref, ef_sh = ref.ef_residual_norm, sh.ef_residual_norm
    if codec.ef and not (ef_ref > 0 and abs(ef_sh - ef_ref)
                         <= 1e-4 * ef_ref):
        raise AssertionError(f"EF residual norms differ: {ef_sh} vs "
                             f"{ef_ref}")
    return sh, curve_diff


def bound(nbytes: float, ops: float):
    """(least ms, what bounds it) for ``nbytes`` of device memory traffic
    and ``ops`` operations."""
    ms_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms_ops = ops / F32_FLOPS_PER_S * 1e3
    return (max(ms_bytes, ms_ops),
            "bytes" if ms_bytes >= ms_ops else "operations")


def receive_bound(valid, variant: str, d: int, msg_bytes: int = None):
    """Least bytes and flops of one receive launch on these inputs: the
    valid lanes; per valid (node, round) the message (``msg_bytes``: its
    payload row with its scale and zero-point, 4 d on the f32 wire) and
    counter read and one cache row and counter written; per node with a
    valid round its x, y, ptr, count, last_t read (last_w too for mu/um)
    and last_w, last_t, ptr, count written."""
    k, n = valid.shape
    if msg_bytes is None:
        msg_bytes = 4 * d
    v = int((valid > 0).sum())
    r = int(((valid > 0).sum(0) > 0).sum())
    nbytes = (4 * k * n + v * ((msg_bytes + 4) + (4 * d + 4))
              + r * ((4 * d + 4) + (4 * d if variant != "rw" else 0)
                     + 4 * d + 3 * 4 + 3 * 4))
    per_elem = {"rw": 5, "mu": 7, "um": 12}[variant]    # merge, margin, step
    ms, by = bound(nbytes, v * per_elem * d)
    return ms, by, nbytes


def send_bound(name: str, n: int, d: int):
    """Least bytes and operations of one send launch: w (and ef) read once;
    codes or packed bytes, the f16 scale (and zero-point) and the EF
    residual written once. About 6 float operations an element, plus ~120
    integer operations of threefry for int8_sr's noise."""
    from repro_torch.core.wire_codec import get_codec
    codec = get_codec(name)
    nbytes = (4 * n * d * (2 if codec.ef else 1)
              + n * codec.payload_bytes(d) + n * codec.overhead_bytes
              + (4 * n * d if codec.ef else 0) + (8 if codec.stochastic
                                                  else 0))
    ops = n * d * (6 + (120 if codec.stochastic else 0))
    ms, by = bound(nbytes, ops)
    return ms, by, nbytes


def profile_run(run, tag: str, card: str):
    """Run ``run()`` under the profiler: wall, device busy time and the
    top device-time entries; prints them and returns a dict."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)
    # device-side events only (kernels, copies): an op's own device time
    # repeats its kernels'
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA), key=dev_us,
                    reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = [(e.key, dev_us(e) / 1e3, e.count) for e in events[:8]
           if dev_us(e) > 0]
    print(f"[{tag}] {card}: profiled rerun wall {pwall:.3f} s, device busy "
          f"{busy_ms:.1f} ms ({busy_ms / 1e3 / pwall:.2%}), idle share "
          f"{1 - busy_ms / 1e3 / pwall:.2%}")
    for key, t_ms, count in top:
        print(f"[{tag}]   {t_ms:9.3f} ms  x{count:<6d} {key[:90]}")
    return dict(wall_s=pwall, device_busy_ms=busy_ms,
                top=[dict(name=k, ms=t, count=c) for k, t, c in top])


def main_path(cfg, X, y, n: int, cycles: int, device):
    """One main-path run (``run_simulation(engine="sharded")`` on the card)
    with every launch count set to 0 just before it and read just after,
    keeping a copy of the last receive and send launches' inputs. Returns
    (result, wall s, peak bytes, receive launches, send launches by
    kernel, captured receive inputs, captured send inputs)."""
    import numpy as np
    import torch
    from repro_torch.core.simulation import run_simulation
    from repro_torch.kernels import gossip_cycle as gc

    recv, send = gc.fused_receive_apply, gc.quantize_send
    got_recv, got_send = {}, {}
    clone = lambda v: v.clone() if isinstance(v, torch.Tensor) else v

    def capture_recv(*a, **kw):
        if recv.launches == cycles - 1:
            got_recv.update({k: v.clone() for k, v in zip(ORDER, a)})
            got_recv.update({k: kw[k].clone() for k in META
                             if kw.get(k) is not None})
            got_recv["wire"] = kw.get("wire")
        return recv(*a, **kw)

    def capture_send(w, name, key=None, ef=None):
        if send.launches[gc.send_kernel_name(name)] == cycles - 1:
            got_send.update(w=w.clone(), name=name, key=clone(key),
                            ef=clone(ef))
        return send(w, name, key=key, ef=ef)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gc.fused_receive_apply, gc.quantize_send = capture_recv, capture_send
    try:
        recv.launches = 0
        for k in send.launches:
            send.launches[k] = 0
        t0 = time.perf_counter()
        res = run_simulation(cfg, X[:n], y[:n], X[n:], y[n:],
                             engine="sharded", cycles=cycles, eval_every=10,
                             seed=0, k_rounds=4, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, sends = recv.launches, dict(send.launches)
    finally:
        gc.fused_receive_apply, gc.quantize_send = recv, send
    peak = torch.cuda.max_memory_allocated()
    if launches != cycles:
        raise AssertionError(f"main path launched the receive kernel "
                             f"{launches} times, expected {cycles}")
    if res.sent_total != (res.delivered_total + res.lost_total
                          + res.overflow_total + res.in_flight_total):
        raise AssertionError("message economy does not add up")
    curves = res.err_fresh + res.err_voted + res.similarity
    if not (len(res.cycles) == 2 and all(np.isfinite(curves))
            and all(0.0 <= e <= 0.5 for e in res.err_fresh + res.err_voted)):
        raise AssertionError(f"bad curves {curves}")
    return res, wall, peak, launches, sends, got_recv, got_send


def time_receive(captured, variant: str, lam: float, d: int):
    """The receive kernel on captured main-path inputs: agreement with the
    plain version there, ms per launch, the plain version's ms, and the
    bound. Returns (max abs err, ms, plain ms, bound ms, bound_by,
    bytes)."""
    from repro_torch.core.wire_codec import get_codec
    from repro_torch.kernels import gossip_cycle as gc
    wire = captured.get("wire")
    inputs = {k: v for k, v in captured.items() if k != "wire"}
    err = compare_kernel(inputs, variant, lam, 1e-5, wire=wire)
    kw = dict(variant=variant, lam=lam, wire=wire)

    def runner(fn):
        st = {k: v.clone() for k, v in inputs.items()}
        args = [st[k] for k in ORDER]
        meta = {k: st[k] for k in META if k in st}
        return lambda: fn(*args, **meta, **kw)
    ms = cuda_time_ms(runner(gc.fused_receive_apply), reps=20)
    plain_ms = cuda_time_ms(runner(gc.fused_receive_apply_plain), reps=5,
                            warmup=1)
    codec = get_codec(wire)
    bound_ms, bound_by, nbytes = receive_bound(
        inputs["valid"], variant, d,
        codec.payload_bytes(d) + codec.overhead_bytes)
    return err, ms, plain_ms, bound_ms, bound_by, nbytes


def time_send(captured):
    """The send kernel on captured main-path inputs: bitwise agreement with
    the plain version there, ms per launch, the plain version's ms and the
    bound."""
    from repro_torch.kernels import gossip_cycle as gc
    w, name, key, ef = (captured[k] for k in ("w", "name", "key", "ef"))
    compare_send(name, w, ef, key)
    ms = cuda_time_ms(lambda: gc.quantize_send(w, name, key=key, ef=ef),
                      reps=20)
    plain_ms = cuda_time_ms(
        lambda: gc.quantize_send_plain(w, name, key=key, ef=ef), reps=5,
        warmup=1)
    bound_ms, bound_by, nbytes = send_bound(name, *w.shape)
    return ms, plain_ms, bound_ms, bound_by, nbytes


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
    import dataclasses

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
            if "Compiling entry" in line:     # which kernel the next lines are
                print(f"[0]   {name}: {line.split(chr(39))[1][:100]}")
            if "registers" in line or "spill" in line:
                print(f"[0]   {name}: {line.strip()}")
    results["build_s"] = build_s

    # ---- 1. kernel vs plain ------------------------------------------------
    max_err = 0.0
    shapes = [(4099, 10, 10, 4, 1e-5), (4099, 57, 10, 4, 1e-5),
              (2000, 9947, 10, 4, 1e-4), (257, 16, 3, 5, 1e-5)]
    for si, (n, d, c, k, atol) in enumerate(shapes):
        for mode, wire in (("f32", None), *DECODE_WIRES.items()):
            inputs = receive_inputs(si, n, d, c, k, dev, wire=wire)
            for variant in ("rw", "mu", "um"):
                err = compare_kernel(inputs, variant, 1e-3, atol, wire=wire)
                max_err = max(max_err, err)
                print(f"[1] fused_receive_apply {mode} N={n} d={d} C={c} "
                      f"K={k} {variant}: ints equal, max abs err {err:.3e} "
                      f"(atol {atol:g}, rtol 1e-5)")
            del inputs
        torch.cuda.empty_cache()
    key = random.key(12345, device=dev)
    for n, d in ((4099, 10), (4099, 57), (2000, 9947), (257, 1), (257, 7)):
        w, ef = send_inputs(n + d, n, d, dev)
        for name in SEND_CODECS:
            outs = compare_send(name, w, ef, key)
            print(f"[1] quantize_send {name} ({gc.send_kernel_name(name)}) "
                  f"N={n} d={d}: {', '.join(outs)} bitwise equal")
    del w, ef
    # int8_sr past 2^32 flat positions (the counter's high word): the
    # kernel over all rows, the plain codec on the first and last rows with
    # their positional noise
    from repro_torch.core.wire_codec import quantize_wire
    n, d = 432_000, 9947
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    w = torch.randn((n, d), generator=g, device=dev)
    q, sc, zp = gc.quantize_send(w, "int8_sr", key=key)
    rows = torch.cat([torch.arange(64), torch.arange(n - 64, n)]).to(dev)
    want = quantize_wire(w[rows], "int8_sr", noise=random.sr_noise_for_rows(
        key, rows, d, n))
    for label, a_, b_ in zip(("q", "scale", "zp"), (q[rows], sc[rows],
                                                    zp[rows]), want):
        if not torch.equal(a_.view(torch.uint8), b_.view(torch.uint8)):
            raise AssertionError(f"int8_sr past 2^32: {label} differs")
    print(f"[1] quantize_send int8_sr N={n} d={d} ({n * d} positions, past "
          "2^32): q, scale, zp of the first and last 64 rows bitwise equal "
          "to the plain codec with sr_noise_for_rows")
    del w, q, sc, zp
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
    results["phase2"] = dict(curve_diff=curve_diff, sent=sh.sent_total,
                             err_fresh=sh.err_fresh, err_voted=sh.err_voted)
    for wire in MAIN_WIRES:
        cfgw = dataclasses.replace(cfg2, wire_dtype=wire)
        shw, dw = compare_engines(cfgw, X, y, n2, dev, cycles=20,
                                  eval_every=10, seed=0, k_rounds=4)
        print(f"[2] {wire} N={n2} extreme 20 cycles: economy equal (sent "
              f"{shw.sent_total}, delivered {shw.delivered_total}); wire "
              f"bytes {shw.wire_bytes_total} equal; max curve difference "
              f"{dw:.3e}; ef_residual_norm {shw.ef_residual_norm:.6g}; "
              f"err_fresh {shw.err_fresh}")
        results["phase2"][wire] = dict(
            curve_diff=dw, sent=shw.sent_total, err_fresh=shw.err_fresh,
            ef_residual_norm=shw.ef_residual_norm)
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

    # ---- 3. full size ------------------------------------------------------
    n3, cycles = 1_000_000, 20
    rng = np.random.default_rng(0)
    X, y = make_linear_dataset(rng, n3 + 1000, 10, noise=0.07,
                               separation=2.5)
    cfg3 = with_failure_scenario(GossipLinearConfig(
        name=f"million-{n3}", dim=10, n_nodes=n3, n_test=1000,
        class_ratio=(1, 1), lam=1e-3, variant="mu", cache_size=10),
        "extreme")

    res, wall, peak, launches, _, captured, _ = main_path(cfg3, X, y, n3,
                                                          cycles, dev)
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
    err3, ms, plain_ms, bound_ms, bound_by, nbytes = time_receive(
        captured, cfg3.variant, cfg3.lam, 10)
    max_err = max(max_err, err3)
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
        wire_bytes_total=res.wire_bytes_total,
        buf_payload_bytes=res.buf_payload_bytes,
        kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_bytes=nbytes)
    f32_res = res
    del captured

    # where the time goes: the same run again under the profiler
    results["profile"] = profile_run(
        lambda: run_simulation(cfg3, X[:n3], y[:n3], X[n3:], y[n3:],
                               engine="sharded", cycles=cycles,
                               eval_every=10, seed=0, k_rounds=4,
                               device="cuda"), "3", card)

    kernels = [dict(
        name="fused_receive_apply", route="cuda",
        source="src/repro_torch/kernels/csrc/gossip_cycle.cu",
        replaces="src/repro/kernels/gossip_cycle.py:272",
        launches=launches, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)]

    # ---- 4. the quantized wire at full size --------------------------------
    results["phase4"] = {}
    send_rows = {}
    for wire in MAIN_WIRES:
        cfg4 = dataclasses.replace(cfg3, wire_dtype=wire)
        kernel = gc.send_kernel_name(wire)
        res, wall, peak, launches, sends, cap_r, cap_s = main_path(
            cfg4, X, y, n3, cycles, dev)
        if sends[kernel] != cycles or sum(sends.values()) != cycles:
            raise AssertionError(f"{wire}: main path launched the send "
                                 f"kernels {sends}, expected {cycles} "
                                 f"{kernel}")
        rate = n3 * cycles / wall
        print(f"[4] {card}: {wire} N={n3} d=10 extreme MU K=4 C=10 "
              f"{cycles} cycles: launches receive {launches}, send "
              f"{kernel} {sends[kernel]}; err_fresh {res.err_fresh} "
              f"err_voted {res.err_voted}; ef_residual_norm "
              f"{res.ef_residual_norm:.6g}")
        print(f"[4] {card}: {wire} economy sent {res.sent_total} = "
              f"delivered {res.delivered_total} + lost {res.lost_total} + "
              f"overflow {res.overflow_total} + in flight "
              f"{res.in_flight_total}")
        print(f"[4] {card}: {wire} wire bytes {res.wire_bytes_total} "
              f"({res.wire_bytes_total / f32_res.wire_bytes_total:.4f} of "
              f"f32's {f32_res.wire_bytes_total}), buffer "
              f"{res.buf_payload_bytes} B "
              f"({res.buf_payload_bytes / f32_res.buf_payload_bytes:.4f} of "
              f"f32's {f32_res.buf_payload_bytes})")
        print(f"[4] {card}: {wire} wall {wall:.3f} s, {rate:.0f} "
              f"node-cycles/s, peak device memory {peak / 2**30:.2f} GiB")
        r_err, r_ms, r_plain, r_bound, r_by, r_bytes = time_receive(
            cap_r, cfg4.variant, cfg4.lam, 10)
        max_err = max(max_err, r_err)
        kernels[0]["launches"] += launches
        kernels[0]["max_abs_err"] = max_err
        print(f"[4] {card}: fused_receive_apply {wire} decode: {r_ms:.4f} "
              f"ms/launch vs bound {r_bound:.4f} ms ({r_by}, {r_bytes} B); "
              f"plain version {r_plain:.4f} ms; max abs err vs plain "
              f"{r_err:.3e}")
        s_ms, s_plain, s_bound, s_by, s_bytes = time_send(cap_s)
        print(f"[4] {card}: quantize_send {wire} ({kernel}): {s_ms:.4f} "
              f"ms/launch vs bound {s_bound:.4f} ms ({s_by}, {s_bytes} B); "
              f"plain version {s_plain:.4f} ms; bitwise equal to plain")
        send_rows[kernel] = dict(launches=sends[kernel], ms=s_ms,
                                 plain_ms=s_plain, bound_ms=s_bound,
                                 bound_by=s_by)
        del cap_r, cap_s
        prof = profile_run(
            lambda: run_simulation(cfg4, X[:n3], y[:n3], X[n3:], y[n3:],
                                   engine="sharded", cycles=cycles,
                                   eval_every=10, seed=0, k_rounds=4,
                                   device="cuda"), "4", card)
        results["phase4"][wire] = dict(
            wall_s=wall, node_cycles_per_s=rate, peak_bytes=peak,
            launches=launches, send_launches=sends, err_fresh=res.err_fresh,
            err_voted=res.err_voted, sent=res.sent_total,
            delivered=res.delivered_total, lost=res.lost_total,
            overflow=res.overflow_total, in_flight=res.in_flight_total,
            wire_bytes_total=res.wire_bytes_total,
            buf_payload_bytes=res.buf_payload_bytes,
            ef_residual_norm=res.ef_residual_norm,
            receive=dict(ms=r_ms, plain_ms=r_plain, bound_ms=r_bound,
                         bound_bytes=r_bytes, max_abs_err=r_err),
            send=dict(ms=s_ms, plain_ms=s_plain, bound_ms=s_bound,
                      bound_bytes=s_bytes),
            profile=prof)
        torch.cuda.empty_cache()

    for kernel, replaces in SEND_ROWS.items():
        kernels.append(dict(
            name=f"quantize_send[{kernel}]", route="cuda",
            source="src/repro_torch/kernels/csrc/quantize_send.cu",
            replaces=replaces, max_abs_err=0.0, library_ms=None,
            **send_rows[kernel]))
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
