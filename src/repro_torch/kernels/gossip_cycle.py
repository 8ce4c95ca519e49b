"""Fused gossip-cycle receive step: K sequential receives per node.

Counterpart of ``repro/kernels/gossip_cycle.py::fused_receive_apply`` (the
Pallas TPU kernel) for float32 messages without a defense screen. For
every node and every valid round k: ``modelCache.add(createModel(m_k,
lastModel)); lastModel <- m_k`` (Algorithm 1 ON RECEIVE) with the Pegasos
update, in the CREATEMODEL variants rw / mu / um.

* ``fused_receive_apply`` dispatches on the tensors' device: CUDA tensors
  go to the hand-written kernel in ``csrc/gossip_cycle.cu`` (built by
  ``nvcc`` for sm_90a at first use), CPU tensors to the plain version.
  There is no fallback: a CUDA tensor reaches the kernel or an exception.
* ``fused_receive_apply_plain`` is the same function in plain PyTorch,
  following ``_cycle_kernel``'s op order; the CPU tests hold it to the JAX
  kernel, and ``chip_smoke.py`` holds the CUDA kernel to it on the card.

Both update ``last_w, last_t, cache_w, cache_t, ptr, count`` in place and
return them. The kernel's design and its bound are described in its source.
"""
from __future__ import annotations

import ctypes
import functools

import torch

VARIANTS = {"rw": 0, "mu": 1, "um": 2}


def _pegasos(w, t, x, y, lam: float):
    """(N, d) Pegasos step in f32, in ``_cycle_kernel._pegasos``'s order."""
    t = t + 1
    eta = 1.0 / (lam * t.to(torch.float32))
    margin = y * torch.sum(w * x, dim=-1)
    decay = (1.0 - eta * lam)[:, None]
    upd = torch.where((margin < 1.0)[:, None], (eta * y)[:, None] * x, 0.0)
    return decay * w + upd, t


def fused_receive_apply_plain(last_w, last_t, cache_w, cache_t, ptr, count,
                              msg_w, msg_t, valid, x, y, *, variant: str,
                              lam: float):
    """The receive step in plain PyTorch, in place; see the module note."""
    n, c, _ = cache_w.shape
    rows = torch.arange(n, device=last_w.device)
    lw, lt = last_w.clone(), last_t.clone()
    for k in range(msg_w.shape[0]):
        vm = valid[k] > 0
        mw, mt = msg_w[k], msg_t[k]
        if variant == "mu":                        # update(merge(m, last))
            nw, nt = _pegasos((mw + lw) / 2.0, torch.maximum(mt, lt), x, y,
                              lam)
        elif variant == "um":                      # merge(update(m), update(last))
            w1, t1 = _pegasos(mw, mt, x, y, lam)
            w2, t2 = _pegasos(lw, lt, x, y, lam)
            nw, nt = (w1 + w2) / 2.0, torch.maximum(t1, t2)
        else:                                      # rw: update(m)
            nw, nt = _pegasos(mw, mt, x, y, lam)
        r = rows[vm]
        slot = (ptr[vm] % c).long()
        cache_w[r, slot] = nw[vm]
        cache_t[r, slot] = nt[vm]
        inc = vm.to(torch.int32)
        ptr += inc
        torch.clamp_max(count + inc, c, out=count)
        lw = torch.where(vm[:, None], mw, lw)       # lastModel <- message
        lt = torch.where(vm, mt, lt)
    last_w.copy_(lw)
    last_t.copy_(lt)
    return last_w, last_t, cache_w, cache_t, ptr, count


def _check(last_w, last_t, cache_w, cache_t, ptr, count, msg_w, msg_t,
           valid, x, y, variant):
    if variant not in VARIANTS:
        raise ValueError(f"unknown CREATEMODEL variant {variant!r}")
    if last_w.ndim != 2 or cache_w.ndim != 3 or msg_w.ndim != 3:
        raise ValueError("expected last_w (N, d), cache_w (N, C, d) and "
                         "msg_w (K, N, d)")
    n, d = last_w.shape
    c = cache_w.shape[1]
    k = msg_w.shape[0]
    spec = {
        "last_w": (last_w, torch.float32, (n, d)),
        "last_t": (last_t, torch.int32, (n,)),
        "cache_w": (cache_w, torch.float32, (n, c, d)),
        "cache_t": (cache_t, torch.int32, (n, c)),
        "ptr": (ptr, torch.int32, (n,)),
        "count": (count, torch.int32, (n,)),
        "msg_w": (msg_w, torch.float32, (k, n, d)),
        "msg_t": (msg_t, torch.int32, (k, n)),
        "valid": (valid, torch.int32, (k, n)),
        "x": (x, torch.float32, (n, d)),
        "y": (y, torch.float32, (n,)),
    }
    for name, (a, dtype, shape) in spec.items():
        if a.device != last_w.device:
            raise ValueError(f"{name} is on {a.device}, last_w on "
                             f"{last_w.device}")
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _kernel():
    from repro_torch.kernels import _build

    lib = _build.load("gossip_cycle")
    fn = lib.gossip_cycle_fused_receive_apply
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = lib.gossip_cycle_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _launch(last_w, last_t, cache_w, cache_t, ptr, count, msg_w, msg_t,
            valid, x, y, variant: str, lam: float):
    fn, err = _kernel()
    n, d = last_w.shape
    with torch.cuda.device(last_w.device):
        stream = torch.cuda.current_stream(last_w.device).cuda_stream
        code = fn(last_w.data_ptr(), last_t.data_ptr(), cache_w.data_ptr(),
                  cache_t.data_ptr(), ptr.data_ptr(), count.data_ptr(),
                  msg_w.data_ptr(), msg_t.data_ptr(), valid.data_ptr(),
                  x.data_ptr(), y.data_ptr(), n, d, cache_w.shape[1],
                  msg_w.shape[0], lam, VARIANTS[variant], stream)
    if code != 0:
        raise RuntimeError("gossip_cycle kernel launch failed: "
                           f"{err(code).decode()} (cudaError {code})")
    _WRAPPER.launches += 1


def fused_receive_apply(last_w, last_t, cache_w, cache_t, ptr, count,
                        msg_w, msg_t, valid, x, y, *, variant: str,
                        lam: float):
    """Fused K-receive apply for one cycle, in place.

    last_w, x: (N, d) f32; last_t, ptr, count: (N,) i32; cache_w: (N, C, d)
    f32; cache_t: (N, C) i32; msg_w: (K, N, d) f32; msg_t, valid: (K, N)
    i32; y: (N,) f32. Returns ``(last_w, last_t, cache_w, cache_t, ptr,
    count)``, the same tensors, updated. Every tensor must be contiguous
    and on one device. The reference kernel's quantized wire modes and
    defense screens are not ported yet (ROADMAP.md queue 2 item 1); the
    engines refuse such configurations before they reach this step."""
    _check(last_w, last_t, cache_w, cache_t, ptr, count, msg_w, msg_t,
           valid, x, y, variant)
    args = (last_w, last_t, cache_w, cache_t, ptr, count, msg_w, msg_t,
            valid, x, y)
    if last_w.device.type == "cpu":
        return fused_receive_apply_plain(*args, variant=variant, lam=lam)
    if last_w.device.type != "cuda":
        raise NotImplementedError(
            f"no receive kernel for device {last_w.device}")
    _launch(*args, variant, float(lam))
    return last_w, last_t, cache_w, cache_t, ptr, count


# Kernel launches so far; only the CUDA path counts. Bound to the wrapper
# object itself, so the count survives a caller wrapping the module
# attribute (chip_smoke.py does, to keep a copy of one launch's inputs).
fused_receive_apply.launches = 0
_WRAPPER = fused_receive_apply
