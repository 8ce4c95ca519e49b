"""Wire codecs: how a transmitted model rides the wire.

A copy of ``repro/core/wire_codec.py`` in PyTorch (that module cannot be
imported here: its package loads JAX). The threefry cipher and the
positional uniform it feeds live in ``repro_torch.random``.

Registered codecs (``WIRE_CODECS``; ``GossipLinearConfig.wire_dtype``
names one):

* ``f32`` (alias ``None``) — full precision, 4 B/coefficient;
* ``bf16`` / ``f16`` — plain dtype cast, 2 B/coefficient;
* ``int8`` / ``int8_sr`` — per-message *affine* int8 with an f16
  (scale, zero-point) pair; ``int8_sr`` rounds stochastically from the
  cycle's ``k_recv`` threefry key, so runs stay bitwise reproducible;
* ``int4`` / ``int4_ef`` — per-message *symmetric* codes in [-7, 7],
  two per byte, one f16 scale ``max|w| / 7``;
* ``ternary`` / ``ternary_ef`` — codes in {-1, 0, +1}, five per byte
  base-3, one f16 scale ``max|w|``.

The ``_ef`` variants keep a sender-side error-feedback residual: the sender
transmits ``encode(w + e)`` and keeps ``e' = (w + e) - decode(encode(w +
e))``, refreshed only on cycles it actually sends. Merge arithmetic is
always f32. Every expression keeps the reference's op order, so codes,
packed bytes, scales and zero-points are equal bit for bit given equal f32
inputs (``tests/test_torch_wire_codec.py``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import random

# int8 codes target [-126, 126]: one code of headroom keeps the clip at
# ±127 inert after the scale is rounded to f16
INT8_QMAX = 126
# int4 codes target [-7, 7], the symmetric subset of the nibble range
INT4_QMAX = 7
# codes packed per byte: two int4 nibbles, five base-3 trits (3^5 = 243)
INT4_GROUP = 2
TERNARY_GROUP = 5

_F16_MAX = float(torch.finfo(torch.float16).max)


def _sat_f16(v):
    """f16 cast that saturates instead of overflowing to inf (NaN stays
    NaN, as ``jnp.clip`` keeps it)."""
    return torch.clamp(v, -_F16_MAX, _F16_MAX).to(torch.float16)


def _div(v, q: int):
    """``v / q`` as an IEEE division. PyTorch's CUDA kernels divide by a
    Python number as a multiply by its reciprocal, which can land one ulp
    away; a divisor tensor on ``v``'s device keeps the division (and the
    reference's rounding) on every device."""
    return v / torch.full((), float(q), dtype=torch.float32, device=v.device)


def _guarded_divisor(scale):
    """``where(scale > 0, scale, 1)`` in f32: a zero (or NaN) scale divides
    by one, so a constant message maps to code 0."""
    one = torch.ones((), dtype=torch.float16, device=scale.device)
    return torch.where(scale > 0, scale, one).to(torch.float32)


# ---------------------------------------------------------------------------
# affine int8 (int8 / int8_sr)
# ---------------------------------------------------------------------------


def _signed_range(w):
    """Per-row ``(min, max)`` over the last axis as ``jnp.min``/``jnp.max``
    take them: NaN propagates, and -0.0 orders below +0.0 wherever the
    zeros lie (``torch.amin``/``amax`` return whichever zero comes first).
    A zero minimum is -0.0 when the row holds a -0.0, a zero maximum +0.0
    when it holds a +0.0."""
    lo = torch.amin(w, dim=-1)
    hi = torch.amax(w, dim=-1)
    zero = w == 0
    neg = torch.signbit(w)
    lo = torch.where(lo == 0, torch.where((zero & neg).any(-1), -0.0, 0.0),
                     lo)
    hi = torch.where(hi == 0, torch.where((zero & ~neg).any(-1), 0.0, -0.0),
                     hi)
    return lo, hi


def quantize_wire(w, name, key=None, noise=None):
    """Per-message affine int8 quantization of a batch of models.

    ``w``: (..., d) f32, one message per slice along the last axis. Returns
    ``(q, scale, zp)``: ``q`` int8 of ``w.shape``, ``scale``/``zp`` f16 of
    ``w.shape[:-1]``. ``zp`` is the f16 range midpoint and ``scale`` covers
    ``max(hi - zp, zp - lo)`` over ``INT8_QMAX`` codes. ``name`` "int8"
    rounds half to even; "int8_sr" adds ``uniform(key, w.shape)`` noise
    before the floor (``noise`` may supply that draw instead of ``key``)."""
    w = w.to(torch.float32)
    lo, hi = _signed_range(w)
    zp = _sat_f16((hi + lo) * 0.5)
    zpf = zp.to(torch.float32)
    scale = _sat_f16(_div(torch.maximum(hi - zpf, zpf - lo), INT8_QMAX))
    sf = _guarded_divisor(scale)
    u = (w - zpf[..., None]) / sf[..., None]
    if name == "int8_sr":
        if noise is None:
            if key is None:
                raise ValueError("int8_sr quantization needs a PRNG key")
            noise = random.uniform(key, w.shape)
        u = torch.floor(u + noise)
    else:
        u = torch.round(u)
    q = torch.clamp(u, -127, 127).to(torch.int8)
    return q, scale, zp


def dequantize_wire(q, scale, zp):
    """Inverse of :func:`quantize_wire`: ``q * scale + zp`` in f32."""
    return (q.to(torch.float32) * scale.to(torch.float32)[..., None]
            + zp.to(torch.float32)[..., None])


# ---------------------------------------------------------------------------
# sub-4-bit packing (integer-exact)
# ---------------------------------------------------------------------------


def _pad_last(x, pad: int, value: int):
    if not pad:
        return x
    fill = torch.full(x.shape[:-1] + (pad,), value, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, fill], dim=-1)


def pack_int4(q):
    """(..., d) int codes in [-8, 7] -> (..., ceil(d/2)) uint8: two's-
    complement nibbles, low nibble = even coordinate, odd d pads code 0."""
    d = q.shape[-1]
    qi = _pad_last(q.to(torch.int32), -d % INT4_GROUP, 0)
    pairs = qi.reshape(qi.shape[:-1] + (qi.shape[-1] // INT4_GROUP,
                                        INT4_GROUP))
    return ((pairs[..., 0] & 0xF)
            | ((pairs[..., 1] & 0xF) << 4)).to(torch.uint8)


def unpack_int4(b, d: int):
    """(..., P) uint8 -> (..., d) int32 sign-extended nibble codes."""
    bi = b.to(torch.int32)
    nib = torch.stack([bi & 0xF, (bi >> 4) & 0xF], dim=-1)
    nib = nib.reshape(b.shape[:-1] + (b.shape[-1] * INT4_GROUP,))[..., :d]
    return ((nib + 8) & 0xF) - 8


def pack_ternary(q):
    """(..., d) codes in {-1, 0, +1} -> (..., ceil(d/5)) uint8: byte =
    sum of (code + 1)·3^k over its five trits; pad trits are code 0."""
    d = q.shape[-1]
    g = _pad_last(q.to(torch.int32) + 1, -d % TERNARY_GROUP, 1)
    g = g.reshape(g.shape[:-1] + (g.shape[-1] // TERNARY_GROUP,
                                  TERNARY_GROUP))
    b = g[..., 0]
    for k in range(1, TERNARY_GROUP):
        b = b + g[..., k] * (3 ** k)
    return b.to(torch.uint8)


def unpack_ternary(b, d: int):
    """(..., P) uint8 -> (..., d) int32 codes in {-1, 0, +1}."""
    bi = b.to(torch.int32)
    digs = torch.stack([torch.div(bi, 3 ** k, rounding_mode="floor") % 3
                        for k in range(TERNARY_GROUP)], dim=-1)
    return digs.reshape(
        b.shape[:-1] + (b.shape[-1] * TERNARY_GROUP,))[..., :d] - 1


def symmetric_scale(w, qmax: int):
    """The packed codecs' scale rule: ``(scale_f16, divisor_f32)`` with one
    saturating f16 ``max|w| / qmax`` per message and its guarded divisor."""
    amax = torch.amax(torch.abs(w), dim=-1)
    scale = _sat_f16(_div(amax, qmax))
    return scale, _guarded_divisor(scale)


# ---------------------------------------------------------------------------
# codec objects
# ---------------------------------------------------------------------------


class WireCodec:
    """One wire representation of a transmitted model: ``payload_dtype``
    (the in-flight buffer's storage), ``bits_per_coeff``,
    ``overhead_bytes`` (per-message metadata), the lanes it carries
    (``has_scale``, ``has_zp``), sender error feedback (``ef``) and whether
    encode consumes a key (``stochastic``). ``encode(w, key=, noise=)`` ->
    ``(payload, scale, zp)`` (None for lanes not carried);
    ``decode(payload, scale, zp, d)`` -> f32."""

    name: str
    payload_dtype = torch.float32
    bits_per_coeff = 32
    overhead_bytes = 0
    has_scale = False
    has_zp = False
    ef = False
    stochastic = False

    def __init__(self, name: str):
        self.name = name

    @property
    def quantized(self) -> bool:
        return self.has_scale

    def payload_cols(self, d: int) -> int:
        """Last-axis width of the payload buffer for d-coefficient models."""
        return d

    def payload_bytes(self, d: int) -> int:
        """Wire bytes of the packed coefficients of one message."""
        return self.payload_cols(d) * self.payload_dtype.itemsize

    def encode(self, w, key=None, noise=None):
        raise NotImplementedError

    def decode(self, payload, scale, zp, d: int):
        raise NotImplementedError

    def roundtrip(self, w, key=None, noise=None):
        """decode(encode(w)): the receiver's view of a transmitted model."""
        payload, scale, zp = self.encode(w, key=key, noise=noise)
        return self.decode(payload, scale, zp, w.shape[-1])

    def __repr__(self):
        return f"<WireCodec {self.name}>"


class FloatCodec(WireCodec):
    """Plain dtype cast (f32 / bf16 / f16): no metadata, no state."""

    def __init__(self, name: str, dtype, bits: int):
        super().__init__(name)
        self.payload_dtype = dtype
        self.bits_per_coeff = bits

    def encode(self, w, key=None, noise=None):
        return w.to(self.payload_dtype), None, None

    def decode(self, payload, scale, zp, d: int):
        return payload.to(torch.float32)


class AffineInt8Codec(WireCodec):
    """Per-message affine int8 (:func:`quantize_wire`)."""

    payload_dtype = torch.int8
    bits_per_coeff = 8
    overhead_bytes = 4            # f16 scale + f16 zero-point
    has_scale = True
    has_zp = True

    def __init__(self, name: str, stochastic: bool):
        super().__init__(name)
        self.stochastic = stochastic

    def encode(self, w, key=None, noise=None):
        return quantize_wire(w, self.name, key=key, noise=noise)

    def decode(self, payload, scale, zp, d: int):
        return dequantize_wire(payload, scale, zp)


class PackedSymmetricCodec(WireCodec):
    """Symmetric codes packed several per byte, one f16 scale per message,
    no zero-point, round half to even (int4, ternary and their ``_ef``
    variants)."""

    payload_dtype = torch.uint8
    overhead_bytes = 2                      # f16 scale only
    has_scale = True

    def __init__(self, name: str, qmax: int, group: int, pack, unpack,
                 ef: bool):
        super().__init__(name)
        self.qmax = qmax
        self.group = group
        self._pack = pack
        self._unpack = unpack
        self.ef = ef
        self.bits_per_coeff = 8 / group     # 4 for int4, 1.6 for ternary

    def payload_cols(self, d: int) -> int:
        return -(-d // self.group)          # ceil(d / codes-per-byte)

    def quantize_codes(self, w):
        """(codes int32 in [-qmax, qmax], scale f16) before packing."""
        w = w.to(torch.float32)
        scale, sf = symmetric_scale(w, self.qmax)
        q = torch.clamp(torch.round(w / sf[..., None]),
                        -self.qmax, self.qmax).to(torch.int32)
        return q, scale

    def encode(self, w, key=None, noise=None):
        q, scale = self.quantize_codes(w)
        return self._pack(q), scale, None

    def decode(self, payload, scale, zp, d: int):
        q = self._unpack(payload, d)
        return q.to(torch.float32) * scale.to(torch.float32)[..., None]


WIRE_CODECS: Dict[str, WireCodec] = {}


def _register(codec: WireCodec) -> WireCodec:
    if codec.name in WIRE_CODECS:
        raise ValueError(f"wire codec {codec.name!r} registered twice")
    WIRE_CODECS[codec.name] = codec
    return codec


_register(FloatCodec("f32", torch.float32, 32))
_register(FloatCodec("bf16", torch.bfloat16, 16))
_register(FloatCodec("f16", torch.float16, 16))
_register(AffineInt8Codec("int8", stochastic=False))
_register(AffineInt8Codec("int8_sr", stochastic=True))
_register(PackedSymmetricCodec("int4", INT4_QMAX, INT4_GROUP,
                               pack_int4, unpack_int4, ef=False))
_register(PackedSymmetricCodec("int4_ef", INT4_QMAX, INT4_GROUP,
                               pack_int4, unpack_int4, ef=True))
_register(PackedSymmetricCodec("ternary", 1, TERNARY_GROUP,
                               pack_ternary, unpack_ternary, ef=False))
_register(PackedSymmetricCodec("ternary_ef", 1, TERNARY_GROUP,
                               pack_ternary, unpack_ternary, ef=True))


def get_codec(name: Optional[str]) -> WireCodec:
    """Registry lookup; ``None``/``""`` alias the f32 codec."""
    if not name:
        return WIRE_CODECS["f32"]
    try:
        return WIRE_CODECS[name]
    except KeyError:
        raise ValueError(f"unknown wire dtype {name!r} "
                         f"(expected one of {sorted(WIRE_CODECS)})") from None


def deterministic_codec(codec: WireCodec) -> WireCodec:
    """The round-to-nearest sibling of a stochastic codec (int8_sr ->
    int8); identity otherwise."""
    if not codec.stochastic:
        return codec
    return WIRE_CODECS[codec.name.replace("_sr", "")]


# ---------------------------------------------------------------------------
# the reference's wire-name helpers (its pre-registry API)
# ---------------------------------------------------------------------------


def resolve_wire_dtype(name) -> Optional[torch.dtype]:
    """Wire-dtype name -> payload storage dtype, or None for full precision
    (``None``/``""``/``"f32"``). Packed sub-4-bit codecs store several
    codes per uint8 element: per-coefficient accounting goes through
    ``get_codec(name).payload_bytes(d)``, not this dtype's itemsize."""
    if not name or name == "f32":
        return None
    return get_codec(name).payload_dtype


def is_quantized_wire(name) -> bool:
    """True when the codec carries a per-message scale (int8 and below)."""
    return bool(name) and get_codec(name).quantized


def is_stochastic_wire(name) -> bool:
    """True when the wire codec rounds stochastically (needs a key)."""
    return bool(name) and get_codec(name).stochastic


def wire_itemsize(name) -> int:
    """Bytes per payload storage element for a wire-dtype name (1 for
    every sub-byte codec: a uint8 element packs ``group`` codes)."""
    dt = resolve_wire_dtype(name)
    return 4 if dt is None else dt.itemsize


def wire_overhead_bytes(name) -> int:
    """Per-message metadata bytes beyond the coefficients: f16 scale and
    zero-point for the affine int8 codecs, f16 scale for the packed
    symmetric codecs, nothing for float casts."""
    return get_codec(name).overhead_bytes if name else 0
