"""Threefry-2x32 keys and draws, bit for bit equal to ``jax.random``.

The protocol's routing (destination, delay, drop) comes from these draws,
so the port must reproduce JAX's default *partitionable* threefry scheme
exactly (``jax_threefry_partitionable=True``):

* a key is a pair of uint32 words; ``key(seed)`` is ``(seed >> 32, seed)``;
* ``split(key, n)`` hashes the counters ``(i >> 32, i & 0xFFFFFFFF)`` and
  returns the pairs ``(bits1[i], bits2[i])`` as the new keys;
* 32-bit ``random_bits`` hashes the same counter pair for each flat
  position ``i`` (the full 64-bit index, as ``iota_2x32_shape`` counts) and
  returns ``bits1 ^ bits2``. A draw is therefore positional: ``uniform_at``
  evaluates ``uniform(key, shape)`` at any flat positions without drawing
  the rest, which is how the ``int8_sr`` send kernel makes its noise.

``normal`` is ``jax.random.normal`` in float32 and bfloat16, bit for bit: a
uniform draw on (nextafter(-1, 0), 1) through XLA's float32 ``erf_inv``
polynomial, whose ``log1p`` and ``log`` are XLA's CPU code (``log1p_xla``,
``log_xla``), not PyTorch's.

PyTorch has only partial ``uint32`` arithmetic, so the words live in
``int64`` tensors holding values in ``[0, 2**32)``: every add is masked
with ``& 0xFFFFFFFF`` and every shift is logical (the values are never
negative). A key is an ``int64`` tensor of shape ``(2,)`` (or ``(..., 2)``
for a stack of keys); every draw runs on the key's device, and gives the
same bits on every device.
"""
from __future__ import annotations

import math

from typing import Optional

import torch

from repro_torch.utils.device import resolve_device

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on int64 tensors of uint32 values — the
    op order of ``repro.core.wire_codec.threefry2x32``. Keys broadcast
    against the counters."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    a = (x0 + ks[0]) & MASK32
    b = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return a, b


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` as its raw ``(2,)`` key data."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32],
                        dtype=torch.int64, device=resolve_device(device))


def _hash_positions(k, p):
    """Threefry of the counters ``(p >> 32, p & 0xFFFFFFFF)`` for int64 flat
    positions ``p`` — the 64-bit counter split of ``iota_2x32_shape``."""
    return threefry2x32(k[0], k[1], p >> 32, p & MASK32)


def _hash_counters(k, size: int):
    """Threefry of the counters of flat positions ``0 .. size - 1``."""
    return _hash_positions(
        k, torch.arange(size, dtype=torch.int64, device=k.device))


def split(k, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> (num, 2) keys."""
    b1, b2 = _hash_counters(k, num)
    return torch.stack([b1, b2], dim=-1)


def fold_in(k, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a key ``(2,)`` or a stack of
    keys ``(..., 2)``, on the keys' device: threefry of the counter
    ``(0, uint32(data))`` (jax's ``threefry_seed`` of a 32-bit value),
    returned as the new key words."""
    zero = torch.zeros_like(k[..., 0])
    b1, b2 = threefry2x32(k[..., 0], k[..., 1], zero,
                          zero + (int(data) & MASK32))
    return torch.stack([b1, b2], dim=-1)


def random_bits(k, shape) -> torch.Tensor:
    """32-bit ``jax.random.bits(key, shape)`` as int64 values."""
    shape = tuple(shape)
    b1, b2 = _hash_counters(k, math.prod(shape))
    return (b1 ^ b2).reshape(shape)


def _bits_to_unit_float(bits):
    """uint32 bits (as int64) -> float32 on ``[0, 1)``: the top 23 bits fill
    the mantissa of a float in ``[1, 2)``, minus 1."""
    fbits = (bits >> 9) | 0x3F800000
    return fbits.to(torch.int32).view(torch.float32) - 1.0


def uniform(k, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 on ``[0, 1)``."""
    return _bits_to_unit_float(random_bits(k, shape))


def uniform_at(k, p) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` evaluated at int64 flat positions
    ``p`` of any shape: ``uniform_at(k, p) == uniform(k, shape).reshape(-1)
    [p]`` bitwise, at O(p.numel()) threefry work. The counter of position
    ``p`` is ``(p >> 32, p & 0xFFFFFFFF)``, so positions past 2**32 (an
    (N, d) draw at N = 10^6, d = 9947) hash what JAX hashes there."""
    b1, b2 = _hash_positions(k, p.to(torch.int64))
    return _bits_to_unit_float(b1 ^ b2)


def sr_noise_for_rows(k, rows, d: int, n: Optional[int]) -> torch.Tensor:
    """The ``int8_sr`` noise ``uniform(k, (n, d))[rows]`` for the given row
    indices only: (len(rows), d) float32, bitwise equal to the full draw.
    ``n``, the full draw's row count, is the reference helper's argument;
    the partitionable scheme counts flat positions, so the noise of a row
    does not depend on it (rows must lie in ``[0, n)``; ``None`` where the
    caller does not know ``n``)."""
    rows = torch.as_tensor(rows, dtype=torch.int64, device=k.device)
    p = rows[:, None] * d + torch.arange(d, dtype=torch.int64,
                                         device=k.device)[None, :]
    return uniform_at(k, p)


def randint(k, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` -> int32.

    Two 32-bit draws (from ``split(key)``) folded into ``[minval,
    maxval)`` with JAX's uint32 wraparound arithmetic."""
    k1, k2 = split(k)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = (mult * mult) % span
    off = (((hi % span) * mult) & MASK32) + lo % span
    off = (off & MASK32) % span
    return (minval + off).to(torch.int32)


def bernoulli(k, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` in f32."""
    u = uniform(k, shape)
    return u < torch.tensor(p, dtype=torch.float32, device=u.device)


def permutation(k, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` -> int64 permutation of
    ``arange(n)``: ``ceil(3 ln n / ln(2**32 - 1))`` stable sorts by fresh
    32-bit keys."""
    x = torch.arange(n, dtype=torch.int64, device=k.device)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(MASK32)))
    for _ in range(rounds):
        k, sub = split(k)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


# XLA's float32 log on the CPU (``llvm.log.f32`` lowered to Eigen's
# ``plog_float``, the Cephes polynomial): the coefficients p0 .. p8 of its
# polynomial in the reduced argument, and ln 2 split as q2 + q1
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRT_HALF = 0.707106781186547524
# XLA's float32 log1p for |x| < sqrt(2) - 1: the Cephes rational P(x)/Q(x),
# coefficients highest first
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG1P_SMALL = math.sqrt(2) - 1


def _f32(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _xla_edges(x, finite):
    """XLA's log at the edges of its domain around ``finite``: -inf at
    zero, +inf at +inf, and the all-ones NaN word below zero and at NaN."""
    nan = torch.tensor(-1, dtype=torch.int32, device=x.device).view(
        torch.float32)
    out = torch.where((x < 0) | torch.isnan(x), nan, finite)
    out = torch.where(x == 0, -math.inf, out)
    return torch.where(x == math.inf, math.inf, out)


def log_xla(x) -> torch.Tensor:
    """XLA's float32 ``log`` as its CPU backend computes it, bit for bit
    (``tools/check_xla_log.py`` holds it to ``jax.jit(jnp.log)`` on every
    float32 word from +0 to +inf; tests/test_torch_random.py on samples):
    Eigen's ``plog_float``. The argument (subnormals read as zero, as XLA's
    arithmetic reads them) is split as 2^e m with m in [sqrt(1/2),
    sqrt(2)); the polynomial in t = m - 1 runs as three two-step Horner
    chains joined by t^3, every multiply-add fused as LLVM contracts them;
    then ``fma(y, t^3, q1 e)``, ``fma(-0.5, t^2, t)``, their sum, and
    ``fma(q2, e, .)``. ``torch.log`` is another approximation (about 7 %
    of the results there differ by an ulp)."""
    from repro_torch.core.faults import _fma, _ftz  # faults imports this

    x = _ftz(x.to(torch.float32))
    m = torch.clamp(x, min=float(torch.finfo(torch.float32).tiny))
    bits = m.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    low = m < _f32(_SQRT_HALF, x)
    e = e - low.to(torch.float32)
    t = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    t2 = t * t
    t3 = t2 * t

    def chain(i):
        c = [_f32(v, x) for v in _LOG_P[i:i + 3]]
        return _fma(_fma(c[0], t, c[1]), t, c[2])
    y = _fma(chain(0), t3, chain(3))
    y = _fma(y, t3, chain(6))
    y = _fma(y, t3, _f32(_LOG_Q1, x) * e)
    r = _fma(_f32(-0.5, x), t2, t) + y
    r = _fma(_f32(_LOG_Q2, x), e, r)
    return _xla_edges(x, r)


def log1p_xla(x) -> torch.Tensor:
    """XLA's float32 ``log1p`` as its CPU backend computes it, bit for bit
    (``tools/check_xla_log.py`` holds it to ``jax.jit(jnp.log1p)`` on every
    float32 word from -0 to -1 and from +0 to +inf; tests/test_torch_random.py
    on samples). For |x| < sqrt(2) - 1
    the Cephes rational: P(x) and Q(x) by Horner steps as fused
    multiply-adds, then ``x + fma(-0.5, x^2, (x x^2) (P / Q))``; elsewhere
    ``log_xla(1 + x)``. Subnormal arguments read as zero."""
    from repro_torch.core.faults import _fma, _ftz  # faults imports this

    x = _ftz(x.to(torch.float32))
    x2 = x * x
    p, q = _f32(_LOG1P_P[0], x), _f32(_LOG1P_Q[0], x)
    for cp, cq in zip(_LOG1P_P[1:], _LOG1P_Q[1:]):
        p = _fma(p, x, _f32(cp, x))
        q = _fma(q, x, _f32(cq, x))
    small = x + _fma(_f32(-0.5, x), x2, (x * x2) * (p / q))
    return torch.where(x.abs() < _f32(_LOG1P_SMALL, x), small,
                       log_xla(1.0 + x))


# XLA's float32 erf_inv (Giles' polynomial): the coefficients of p(w), highest
# first, for w = -log1p(-x^2) < 5 (evaluated at w - 2.5) and >= 5 (at
# sqrt(w) - 3)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` of float32 ``x`` on [-1, 1], bit for bit:
    Giles' polynomial in ``w = -log1p_xla(-x^2)``, the Horner steps as
    fused multiply-adds (as XLA's CPU code contracts them), +-inf at +-1.
    ``torch.erfinv`` is another approximation; ``torch.log1p`` is not
    XLA's (it moved about 1 % of the results by up to 3 ulps), and
    ``torch.sqrt`` on the CPU is not correctly rounded (``faults._sqrt``
    is; it moved 1 to 4 results in 200,000, all at w >= 5)."""
    from repro_torch.core.faults import _fma, _sqrt  # faults imports this

    w = -log1p_xla(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, _sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], device=x.device),
                           torch.tensor(_ERFINV_GE5[i], device=x.device))
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coef(i))
    return torch.where(x.abs() == 1, x * math.inf, p * x)


def normal(k, shape, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` for float32 and bfloat16:
    ``uniform`` on (nextafter(-1, 0), 1) in ``dtype`` (the span rounds to
    2, so u = max(lo, 2 f + lo) for f on [0, 1)), then sqrt(2) times
    ``erf_inv(u)``. A bfloat16 draw takes 8 random bits (the low byte of
    the 32-bit word) for its 7 mantissa bits, computes ``erf_inv`` in
    float32, rounds it to bfloat16 and multiplies by bfloat16's sqrt(2),
    as XLA does: 128 distinct words."""
    bits = random_bits(k, shape)
    if dtype == torch.float32:
        f = _bits_to_unit_float(bits)
    elif dtype == torch.bfloat16:
        # the bf16 word (b8 >> 1) | 0x3F80 as the top half of a float32
        f = ((((bits & 0xFF) >> 1) | 0x3F80) << 16).to(torch.int32).view(
            torch.float32) - 1.0
    else:
        raise ValueError(f"normal draws float32 or bfloat16, not {dtype}")
    lo = torch.tensor(-1.0, dtype=dtype, device=bits.device).nextafter(
        torch.tensor(0.0, dtype=dtype, device=bits.device)).float()
    u = torch.maximum((2.0 * f + lo).to(dtype), lo.to(dtype))
    sqrt2 = torch.tensor(math.sqrt(2), dtype=dtype, device=u.device)
    return (erf_inv(u.float()).to(dtype).float() * sqrt2.float()).to(dtype)
