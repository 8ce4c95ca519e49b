"""Fused gossip-cycle kernels: the K-receive step and the send-side encode.

Counterpart of ``repro/kernels/gossip_cycle.py`` (the Pallas TPU kernels).

* ``fused_receive_apply``: for every node and every valid round k,
  ``modelCache.add(createModel(m_k, lastModel)); lastModel <- m_k``
  (Algorithm 1 ON RECEIVE) with the Pegasos update, in the CREATEMODEL
  variants rw / mu / um. Messages arrive in any wire codec's payload
  (``wire=``): f32/bf16/f16 are upcast, affine int8 is dequantized from its
  f16 scale and zero-point, packed int4 and ternary are unpacked and
  scaled, so message traffic is paid at wire width. A ``defense`` screens
  each decoded message against the current lastModel before the merge
  (``faults.apply_defense``: ``norm_clip`` rescales, ``cosine_gate``
  rejects, both reject non-finite messages) and counts, per node, the
  messages it rejected and rescaled.
* ``quantize_send``: the encode of a quantized wire codec for a population
  of fresh models — affine int8 (``int8``; ``int8_sr`` with the cycle's
  threefry noise made in the kernel), or the packed symmetric codecs with
  the error-feedback residual from the same pass.

Each wrapper dispatches on the tensors' device: CUDA tensors go to the
hand-written kernels in ``csrc/gossip_cycle.cu`` and ``csrc/quantize_send.cu``
(built by ``nvcc`` for sm_90a at first use), CPU tensors to the plain
version beside it. The receive step has two kernels, chosen by
``receive_route`` from d and K before the launch: ``"grouped"`` (a group of
lanes sized to d a node, every valid round's operands loaded before the
rounds run) for d <= 32 and K <= 8, ``"strided"`` (a warp a node) for the
rest; they give the same bits where both apply. The send encode has two
too, chosen by ``send_route``: ``"tiled"`` (persistent blocks walking tiles
of rows through shared memory) at d <= 57 on 16-byte aligned models (and
residuals), ``"strided"`` (a warp a row) for the rest, bit for bit
alike. There is no fallback: a CUDA tensor reaches a
kernel or an exception. The plain versions follow the Pallas kernels' op
order; the CPU tests hold them to the JAX kernels, and ``chip_smoke.py``
holds the CUDA kernels to them on the card. The kernels' designs and
bounds are described in their sources.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import random
from repro_torch.core import faults
from repro_torch.core.wire_codec import (get_codec, quantize_wire,
                                         unpack_int4, unpack_ternary)
# the (N, d) Pegasos step in f32, in ``_cycle_kernel._pegasos``'s order
from repro_torch.kernels.ref import pegasos_update_ref as _pegasos

VARIANTS = {"rw": 0, "mu": 1, "um": 2}
# the receive kernel's decode modes (template argument of the CUDA kernel)
DECODE_MODES = {"f32": 0, "bf16": 1, "f16": 2, "affine8": 3, "int4": 4,
                "ternary": 5}
_FLOAT_MODES = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16"}
# the receive kernel's screens (template argument of the CUDA kernel)
DEFENSE_CODES = {name: i for i, name in enumerate(faults.DEFENSES)}
# the receive kernel's routes (their codes in the C entry) and the widest d
# and largest K the grouped route takes
RECEIVE_ROUTES = ("grouped", "strided")
GROUPED_MAX_WIDTH = 32
GROUPED_MAX_ROUNDS = 8


def receive_route(d: int, k: int) -> str:
    """Which receive kernel serves d coefficients and K rounds on CUDA:
    ``"grouped"`` for d <= 32 and K <= 8 (a group of the smallest power of
    two >= d lanes a node), else ``"strided"`` (a warp a node)."""
    if d <= GROUPED_MAX_WIDTH and k <= GROUPED_MAX_ROUNDS:
        return "grouped"
    return "strided"


# the send kernel's routes (their codes in the C entries), the widest d the
# rule sends to the tiled route (of the widths chip_smoke.py times both
# routes at, 10, 32, 57 and 128, the widest where tiled is the faster on an
# H100), and the widest d its kernels take
SEND_ROUTES = ("tiled", "strided")
TILED_MAX_WIDTH = 57
TILED_KERNEL_MAX_WIDTH = 128
# a tile of the tiled route: at most 256 rows and a 32 KB slot for the
# tiles of w (and ef), a multiple of 16 rows (csrc/tiled.cuh::tiled_rows,
# csrc/quantize_send.cu::send_rows)
_TILED_MAX_ROWS = 256
_TILED_SLOT_BYTES = 32768


def send_tile_rows(d: int, ef: bool = False) -> int:
    """Rows a tile of the tiled send route holds at width d: as many as a
    32 KB slot holds of the staged float32 inputs (w, and ef under error
    feedback), rounded down to a multiple of 16, at most 256."""
    row_bytes = 4 * d * (2 if ef else 1)
    return min(_TILED_MAX_ROWS, _TILED_SLOT_BYTES // row_bytes // 16 * 16)


def send_route(d: int, name: str, aligned: bool = True) -> str:
    """Which send kernel encodes codec ``name`` at width d on CUDA:
    ``"tiled"`` at d <= 57 when the models' data, and the error-feedback
    residual's for the ``_ef`` codecs, start on a 16-byte boundary
    (``aligned``; the tiles are copied 16 bytes at a time), else
    ``"strided"`` (a warp a row): wider rows, and operands at an unaligned
    offset, such as a view that starts mid-row."""
    get_codec(name)                       # raises on an unknown codec
    if d <= TILED_MAX_WIDTH and aligned:
        return "tiled"
    return "strided"


def send_aligned(w, ef=None) -> bool:
    """Whether the send operands start on 16-byte boundaries, as the tiled
    route copies them: the models ``w`` and, under error feedback, ``ef``
    (the residual the wrapper allocates always does)."""
    return w.data_ptr() % 16 == 0 and (ef is None
                                       or ef.data_ptr() % 16 == 0)


def _wire_mode(wire, msg_scale, msg_zp) -> str:
    """The reference's static decode mode for a codec name: "float",
    "affine8", "int4" or "ternary". Scale and zero-point without a name
    mean affine int8; a scale alone is ambiguous (the packed codecs must
    name themselves) and raises."""
    if wire is not None:
        codec = get_codec(wire)
        if not codec.quantized:
            return "float"
        if codec.has_zp:
            return "affine8"
        return "int4" if codec.group == 2 else "ternary"
    if msg_scale is not None and msg_zp is not None:
        return "affine8"
    if msg_scale is not None:
        raise ValueError("msg_scale without msg_zp needs an explicit "
                         "wire= codec name (scale-only codecs are packed)")
    return "float"


def _decode_msg(raw, msc, mzp, d: int, mode: str):
    """(K, N, P) payload -> (K, N, d) f32 coefficients, in ``_decode_msg``'s
    op order: cast, then multiply by the scale, then add the zero-point."""
    if mode == "float":
        return raw.to(torch.float32)
    if mode == "affine8":
        return (raw.to(torch.float32) * msc.to(torch.float32)[..., None]
                + mzp.to(torch.float32)[..., None])
    unpack = unpack_int4 if mode == "int4" else unpack_ternary
    return (unpack(raw, d).to(torch.float32)
            * msc.to(torch.float32)[..., None])


def fused_receive_apply_plain(last_w, last_t, cache_w, cache_t, ptr, count,
                              msg_w, msg_t, valid, x, y, *, msg_scale=None,
                              msg_zp=None, wire=None, variant: str,
                              lam: float, defense: str = "none"):
    """The receive step in plain PyTorch, in place; see the module note.
    Returns the six state tensors and the (N,) int32 ``gated`` and
    ``clipped`` counts."""
    n, c, d = cache_w.shape
    msg_w = _decode_msg(msg_w, msg_scale, msg_zp, d,
                        _wire_mode(wire, msg_scale, msg_zp))
    rows = torch.arange(n, device=last_w.device)
    lw, lt = last_w.clone(), last_t.clone()
    gated = torch.zeros(n, dtype=torch.int32, device=last_w.device)
    clipped = torch.zeros_like(gated)
    for k in range(msg_w.shape[0]):
        mw, vm, g, cl = faults.apply_defense(defense, msg_w[k], valid[k] > 0,
                                             lw)
        gated += g.to(torch.int32)
        clipped += cl.to(torch.int32)
        mt = msg_t[k]
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
    return last_w, last_t, cache_w, cache_t, ptr, count, gated, clipped


def _check_tensors(ref, spec):
    """Every tensor of ``spec`` (name -> (tensor, dtype, shape)) on
    ``ref``'s device, of its dtype and shape, and contiguous."""
    for name, (a, dtype, shape) in spec.items():
        if a.device != ref.device:
            raise ValueError(f"{name} is on {a.device}, expected "
                             f"{ref.device}")
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_receive(last_w, last_t, cache_w, cache_t, ptr, count, msg_w,
                   msg_t, valid, x, y, msg_scale, msg_zp, wire, variant,
                   defense):
    """Validate the receive step's operands; returns its decode mode (a
    key of ``DECODE_MODES``)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown CREATEMODEL variant {variant!r}")
    faults.check_defense(defense)
    if last_w.ndim != 2 or cache_w.ndim != 3 or msg_w.ndim != 3:
        raise ValueError("expected last_w (N, d), cache_w (N, C, d) and "
                         "msg_w (K, N, P)")
    n, d = last_w.shape
    c = cache_w.shape[1]
    k = msg_w.shape[0]
    mode = _wire_mode(wire, msg_scale, msg_zp)
    if mode == "float":
        if msg_scale is not None or msg_zp is not None:
            raise ValueError("float wire codecs carry no scale or zero-point")
        if msg_w.dtype not in _FLOAT_MODES:
            raise TypeError(f"msg_w must be float32, bfloat16 or float16 on "
                            f"a float wire, got {msg_w.dtype}")
        if wire is not None and msg_w.dtype != get_codec(wire).payload_dtype:
            raise TypeError(f"msg_w must be {get_codec(wire).payload_dtype} "
                            f"for wire={wire!r}, got {msg_w.dtype}")
        dtype, cols = msg_w.dtype, d
        kernel_mode = _FLOAT_MODES[dtype]
    elif mode == "affine8":
        if msg_scale is None or msg_zp is None:
            raise ValueError(f"wire={wire!r} needs msg_scale and msg_zp")
        dtype, cols, kernel_mode = torch.int8, d, "affine8"
    else:
        if msg_scale is None:
            raise ValueError(f"wire={wire!r} needs msg_scale")
        if msg_zp is not None:
            raise ValueError(f"wire={wire!r} carries no zero-point")
        dtype, cols = torch.uint8, get_codec(wire).payload_cols(d)
        kernel_mode = mode
    spec = {
        "last_w": (last_w, torch.float32, (n, d)),
        "last_t": (last_t, torch.int32, (n,)),
        "cache_w": (cache_w, torch.float32, (n, c, d)),
        "cache_t": (cache_t, torch.int32, (n, c)),
        "ptr": (ptr, torch.int32, (n,)),
        "count": (count, torch.int32, (n,)),
        "msg_w": (msg_w, dtype, (k, n, cols)),
        "msg_t": (msg_t, torch.int32, (k, n)),
        "valid": (valid, torch.int32, (k, n)),
        "x": (x, torch.float32, (n, d)),
        "y": (y, torch.float32, (n,)),
    }
    if msg_scale is not None:
        spec["msg_scale"] = (msg_scale, torch.float16, (k, n))
    if msg_zp is not None:
        spec["msg_zp"] = (msg_zp, torch.float16, (k, n))
    _check_tensors(last_w, spec)
    return kernel_mode


@functools.lru_cache(maxsize=None)
def _lib(name: str):
    """The loaded library of ``csrc/<name>.cu`` and its error-string
    function (built at first use)."""
    from repro_torch.kernels import _build

    lib = _build.load(name)
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib, err


@functools.lru_cache(maxsize=None)
def _entry(lib_name: str, fn_name: str, argtypes: tuple):
    """A kernel's C entry point with its argument types declared."""
    lib, err = _lib(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn, err


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(code: int, err, what: str):
    if code != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{err(code).decode()} (cudaError {code})")


def _ptr(t):
    return None if t is None else t.data_ptr()


_VP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _launch_receive(last_w, last_t, cache_w, cache_t, ptr, count, msg_w,
                    msg_t, valid, x, y, msg_scale, msg_zp, mode: str,
                    variant: str, lam: float, defense: str, route=None):
    """Launch the receive kernel on checked operands. ``route`` overrides
    ``receive_route`` (for holding the two kernels to each other on the
    card); the public wrapper never passes it."""
    n, d = last_w.shape
    k = msg_w.shape[0]
    if route is None:
        route = receive_route(d, k)
    elif route not in RECEIVE_ROUTES or (route == "grouped" and
                                         receive_route(d, k) != route):
        raise ValueError(f"the {route!r} receive route does not take d={d}, "
                         f"K={k}")
    fn, err = _entry("gossip_cycle", "gossip_cycle_fused_receive_apply",
                     (_VP,) * 14 + (_INT,) * 5 + (_FLOAT,) + (_INT,) * 4
                     + (_VP,) * 2)
    split = (ctypes.c_int * 6)(*screen_splits(n, d, defense))
    # (2, N) gated/clipped counts: zero, and written by the kernel only
    # where a screen rejected or rescaled; none under "none", which screens
    # nothing and answers with a shared zero
    counts = (None if defense == "none" else
              torch.zeros((2, n), dtype=torch.int32, device=last_w.device))
    with torch.cuda.device(last_w.device):
        code = fn(last_w.data_ptr(), last_t.data_ptr(), cache_w.data_ptr(),
                  cache_t.data_ptr(), ptr.data_ptr(), count.data_ptr(),
                  msg_w.data_ptr(), _ptr(msg_scale), _ptr(msg_zp),
                  msg_t.data_ptr(), valid.data_ptr(), x.data_ptr(),
                  y.data_ptr(), _ptr(counts), n, d, cache_w.shape[1], k,
                  msg_w.shape[2], lam, VARIANTS[variant], DECODE_MODES[mode],
                  DEFENSE_CODES[defense], RECEIVE_ROUTES.index(route),
                  ctypes.addressof(split), _stream(last_w))
    _raise_on(code, err, f"gossip_cycle ({route})")
    _RECEIVE.launches += 1
    _RECEIVE.route_launches[route] += 1
    if counts is None:
        zero = _zero_counts(last_w.device).expand(n)
        return zero, zero
    return counts[0], counts[1]


def screen_splits(n: int, d: int, defense: str):
    """The six ints the receive kernel takes for its screen's sum order:
    ``faults.screen_split`` for the squares (one array) and the dot (two)
    where a screen sums some rows unfused (5 <= d <= 8), else a split it
    never reads."""
    if defense == "none" or d not in faults.UNFUSED_WIDTHS:
        return (1, 0, 0) * 2
    return faults.screen_split(n, d, 1) + faults.screen_split(n, d, 2)


@functools.lru_cache(maxsize=None)
def _zero_counts(device):
    """One int32 zero per device, seen as the (N,) gated and clipped counts
    of an unscreened launch (a stride-0 view: in-place writes raise)."""
    return torch.zeros((), dtype=torch.int32, device=device)


def fused_receive_apply(last_w, last_t, cache_w, cache_t, ptr, count,
                        msg_w, msg_t, valid, x, y, *, msg_scale=None,
                        msg_zp=None, wire=None, variant: str, lam: float,
                        defense: str = "none"):
    """Fused K-receive apply for one cycle, in place.

    last_w, x: (N, d) f32; last_t, ptr, count: (N,) i32; cache_w: (N, C, d)
    f32; cache_t: (N, C) i32; msg_t, valid: (K, N) i32; y: (N,) f32.
    ``msg_w`` is the (K, N, P) payload of the codec ``wire`` names: f32,
    bf16 or f16 (P = d) for the float codecs, int8 (P = d) with f16
    ``msg_scale``/``msg_zp`` (K, N) for int8/int8_sr, uint8 (P = ceil(d/2)
    or ceil(d/5)) with ``msg_scale`` for int4/ternary and their ``_ef``
    variants. ``defense`` is one of ``faults.DEFENSES``. Returns
    ``(last_w, last_t, cache_w, cache_t, ptr, count, gated, clipped)``: the
    same six tensors, updated, and the (N,) int32 counts of messages the
    screen rejected and rescaled (zeros under "none"). Every tensor must be
    contiguous and on one device. On CUDA, ``receive_route(d, K)`` picks
    the kernel."""
    mode = _check_receive(last_w, last_t, cache_w, cache_t, ptr, count,
                          msg_w, msg_t, valid, x, y, msg_scale, msg_zp, wire,
                          variant, defense)
    args = (last_w, last_t, cache_w, cache_t, ptr, count, msg_w, msg_t,
            valid, x, y)
    if last_w.device.type == "cpu":
        return fused_receive_apply_plain(*args, msg_scale=msg_scale,
                                         msg_zp=msg_zp, wire=wire,
                                         variant=variant, lam=lam,
                                         defense=defense)
    if last_w.device.type != "cuda":
        raise NotImplementedError(
            f"no receive kernel for device {last_w.device}")
    refuse_grad("fused_receive_apply", *args, msg_scale, msg_zp)
    gated, clipped = _launch_receive(*args, msg_scale, msg_zp, mode, variant,
                                     float(lam), defense)
    return last_w, last_t, cache_w, cache_t, ptr, count, gated, clipped


# ---------------------------------------------------------------------------
# send side
# ---------------------------------------------------------------------------


def send_kernel_name(name: str, ef=None) -> str:
    """Which send kernel encodes codec ``name``: the keys of
    ``quantize_send.launches`` ("affine8", "packed_ef", "packed"), rows
    #2, #3 and #4 of the TPU-kernel table in PERF.md. A packed codec runs
    the EF kernel only when a residual is passed: ``ef`` says whether one
    is, and None means as the engines send the codec (a residual for the
    ``_ef`` codecs, none for the rest); the gossip exchange sends an
    ``_ef`` codec one-shot, without one."""
    codec = get_codec(name)
    if codec.has_zp:
        return "affine8"
    if ef is None:
        ef = codec.ef
    return "packed_ef" if ef else "packed"


def refuse_grad(what: str, *tensors) -> None:
    """The CUDA kernels have no backward (nor have the Pallas kernels they
    replace), and their outputs, written through ctypes, carry no autograd
    history: a launch on an input that requires grad would silently cut
    the gradient. So every wrapper raises instead, when grad mode is on
    and any input (None is skipped) requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward; call it under "
            "torch.no_grad() or on tensors that do not require grad")


def quantize_send_plain(w, name: str, key=None, ef=None, rows=None):
    """The send encode in plain PyTorch: the codec's ``encode`` of ``w``
    (``w + ef`` under error feedback), and the residual ``x - q·scale``
    when ``ef`` is given; ``int8_sr``'s noise at the rows ``rows`` of the
    dense draw when they are given; see :func:`quantize_send`."""
    codec = get_codec(name)
    if codec.has_zp:
        noise = None
        if codec.stochastic and rows is not None:
            noise = random.sr_noise_for_rows(key, rows, w.shape[1], None)
        return quantize_wire(w, name, key=None if noise is not None else key,
                             noise=noise)
    x = w + ef if ef is not None else w
    q, scale = codec.quantize_codes(x)
    payload = codec._pack(q)
    if ef is None:
        return payload, scale
    return payload, scale, x - q.to(torch.float32) * scale.to(
        torch.float32)[:, None]


def _check_send(w, name, key, ef, rows=None):
    codec = get_codec(name)
    if not codec.quantized:
        raise ValueError(f"quantize_send needs a quantized wire codec, got "
                         f"{name!r}: float codecs send a plain cast")
    if w.ndim != 2:
        raise ValueError(f"w must be (N, d), got shape {tuple(w.shape)}")
    spec = {"w": (w, torch.float32, tuple(w.shape))}
    if codec.has_zp and ef is not None:
        raise ValueError(f"{name!r} keeps no error-feedback state: ef is "
                         "only accepted by the packed codecs")
    if ef is not None:
        spec["ef"] = (ef, torch.float32, tuple(w.shape))
    if codec.stochastic:
        if key is None:
            raise ValueError("int8_sr quantization needs a PRNG key")
        spec["key"] = (key, torch.int64, (2,))
    if rows is not None:
        spec["rows"] = (rows, torch.int64, (w.shape[0],))
    _check_tensors(w, spec)
    return codec


def _launch_send(w, codec, key, ef, route=None, rows=None):
    """Launch the send kernel on checked operands. ``route`` overrides
    ``send_route`` (for holding the two routes to each other and timing
    them on the card): ``"tiled"`` is refused past d = 128 and on
    unaligned models or residuals; the public wrapper never passes it."""
    n, d = w.shape
    aligned = send_aligned(w, ef)
    if route is None:
        route = send_route(d, codec.name, aligned)
    elif route not in SEND_ROUTES or (route == "tiled" and (
            d > TILED_KERNEL_MAX_WIDTH or not aligned)):
        raise ValueError(f"the {route!r} send route does not take "
                         f"{codec.name!r} at d={d}"
                         + ("" if aligned else " on unaligned models"))
    kernel = send_kernel_name(codec.name, ef is not None)
    dev = w.device
    scale = torch.empty(n, dtype=torch.float16, device=dev)
    with torch.cuda.device(dev):
        if kernel == "affine8":
            fn, err = _entry("quantize_send", "quantize_send_affine8",
                             (_VP,) * 6 + (_INT,) * 4 + (_VP,))
            q = torch.empty((n, d), dtype=torch.int8, device=dev)
            zp = torch.empty(n, dtype=torch.float16, device=dev)
            stochastic = codec.stochastic
            code = fn(w.data_ptr(), _ptr(key if stochastic else None),
                      _ptr(rows if stochastic else None), q.data_ptr(),
                      scale.data_ptr(), zp.data_ptr(), n, d, int(stochastic),
                      SEND_ROUTES.index(route), _stream(w))
            out = (q, scale, zp)
        else:
            fn, err = _entry("quantize_send", "quantize_send_packed",
                             (_VP,) * 5 + (_INT,) * 4 + (_VP,))
            payload = torch.empty((n, codec.payload_cols(d)),
                                  dtype=torch.uint8, device=dev)
            resid = torch.empty_like(w) if ef is not None else None
            code = fn(w.data_ptr(), _ptr(ef), payload.data_ptr(),
                      scale.data_ptr(), _ptr(resid), n, d, codec.group,
                      SEND_ROUTES.index(route), _stream(w))
            out = (payload, scale) if ef is None else (payload, scale, resid)
    _raise_on(code, err, f"quantize_send ({route})")
    if n:             # the entry launches nothing for an empty subset
        _SEND.launches[kernel] += 1
        _SEND.route_launches[route] += 1
    return out


def quantize_send(w, name: str, key=None, ef=None, rows=None):
    """Send-side encode of a quantized wire codec for (N, d) f32 models.

    For the affine int8 codecs returns ``(q, scale, zp)`` (int8 (N, d), f16
    (N,), f16 (N,)), equal bit for bit to ``quantize_wire(w, name, key)``;
    "int8_sr" takes ``key``, the cycle's ``k_recv`` as an int64 (2,) tensor
    of uint32 words on ``w``'s device (never read to the host). ``rows``
    (int64 (N,) on ``w``'s device) says that ``w`` holds those rows of a
    larger population, as the ``compact_all`` send encodes only the
    senders: "int8_sr" then draws the noise of row r at the flat positions
    ``rows[r]·d + j`` of the whole population's draw
    (``random.sr_noise_for_rows``), and the deterministic codecs ignore
    it. For the packed codecs returns ``(payload, scale)`` (uint8 (N,
    ceil(d/g)), f16 (N,)), or ``(payload, scale, resid)`` when ``ef`` (the
    (N, d) f32 error-feedback residual) is given: ``w + ef`` is encoded
    and ``resid = (w + ef) - decode(...)``; the caller applies the send
    mask. The outputs are new tensors (the caller copies them into its
    buffer row). On CUDA, ``send_route(d, name, send_aligned(w, ef))``
    picks the kernel."""
    codec = _check_send(w, name, key, ef, rows)
    if w.device.type == "cpu":
        return quantize_send_plain(w, name, key=key, ef=ef, rows=rows)
    if w.device.type != "cuda":
        raise NotImplementedError(f"no send kernel for device {w.device}")
    refuse_grad("quantize_send", w, ef)
    return _launch_send(w, codec, key, ef, rows=rows)


# Kernel launches so far (the receive kernel's in all and by route, the
# send kernels' by kernel and by route); only the CUDA path counts. Bound
# to the wrapper objects themselves, so the counts survive a caller
# wrapping the module attributes (chip_smoke.py does, to keep a copy of one
# launch's inputs).
fused_receive_apply.launches = 0
fused_receive_apply.route_launches = dict.fromkeys(RECEIVE_ROUTES, 0)
quantize_send.launches = {"affine8": 0, "packed_ef": 0, "packed": 0}
quantize_send.route_launches = dict.fromkeys(SEND_ROUTES, 0)
_RECEIVE = fused_receive_apply
_SEND = quantize_send
