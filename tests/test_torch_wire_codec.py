"""The port's wire codecs (``repro_torch.core.wire_codec``) and positional
noise (``repro_torch.random.uniform_at``/``sr_noise_for_rows``) against the
JAX package, on the same numpy-seeded inputs.

Codes, packed bytes, scales, zero-points and the noise must be equal bit
for bit; decoded floats too (the same ops in the same order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import simulation as jsim
from repro.core import wire_codec as jwc
from repro_torch import random
from repro_torch.core import simulation as psim
from repro_torch.core import wire_codec as pwc

CODECS = sorted(jwc.WIRE_CODECS)
WIDTHS = [1, 7, 10, 57, 130]


def bits(a) -> np.ndarray:
    """A float or integer array's raw bits, for bitwise comparison."""
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
        return a.view(f"u{a.dtype.itemsize}")
    return a


def assert_bitwise(got, want, what=""):
    g, w = bits(got), bits(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert np.array_equal(g, w), (what, int((g != w).sum()))


def models(seed, n, d, scale=1.0):
    """(n, d) f32 rows with a spread of ranges: normal, constant, one
    coordinate, all zero, large and tiny magnitudes."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, d)).astype(np.float32) * scale
    w[0] = 0.0
    if n > 1:
        w[1] = 0.75                              # constant row: scale 0
    if n > 2:
        w[2] *= 1e4                              # near the f16 range
    if n > 3:
        w[3] *= 1e-6                             # f16-subnormal scales
    if n > 4:
        w[4] = np.round(w[4] * 4) / 4            # codes on .5 ties
    return w


@pytest.mark.parametrize("name", CODECS)
def test_registry_lanes_and_accounting_match(name):
    j, p = jwc.get_codec(name), pwc.get_codec(name)
    assert (p.name, p.bits_per_coeff, p.overhead_bytes, p.has_scale,
            p.has_zp, p.ef, p.stochastic, p.quantized) == (
        j.name, j.bits_per_coeff, j.overhead_bytes, j.has_scale, j.has_zp,
        j.ef, j.stochastic, j.quantized)
    assert str(p.payload_dtype).split(".")[-1] == \
        jnp.dtype(j.payload_dtype).name
    for d in (1, 7, 10, 57, 9947):
        assert p.payload_cols(d) == j.payload_cols(d)
        assert p.payload_bytes(d) == j.payload_bytes(d)
        assert psim.message_wire_bytes(d, name) == \
            jsim.message_wire_bytes(d, name)
        assert psim.payload_buffer_bytes(10, 33, d, name) == \
            jsim.payload_buffer_bytes(10, 33, d, name)
    assert pwc.deterministic_codec(p).name == jwc.deterministic_codec(j).name


def test_registry_names_and_aliases():
    assert sorted(pwc.WIRE_CODECS) == CODECS
    assert pwc.get_codec(None).name == pwc.get_codec("").name == "f32"
    with pytest.raises(ValueError, match="unknown wire dtype"):
        pwc.get_codec("int2")


def test_bytes_per_message_at_d57():
    """README's B/msg at d = 57: f32 232, bf16/f16 118, int8 65, int4 35,
    ternary 18."""
    got = {n: psim.message_wire_bytes(57, n) for n in CODECS}
    assert got == {"f32": 232, "bf16": 118, "f16": 118, "int8": 65,
                   "int8_sr": 65, "int4": 35, "int4_ef": 35, "ternary": 18,
                   "ternary_ef": 18}
    assert psim.message_wire_bytes(57, None) == 232


@pytest.mark.parametrize("d", WIDTHS)
def test_pack_unpack_bit_exact(d):
    rng = np.random.default_rng(d)
    q4 = rng.integers(-8, 8, size=(5, d)).astype(np.int32)
    q3 = rng.integers(-1, 2, size=(5, d)).astype(np.int32)
    for pack, unpack, jpack, junpack, q in (
            (pwc.pack_int4, pwc.unpack_int4, jwc.pack_int4, jwc.unpack_int4,
             q4),
            (pwc.pack_ternary, pwc.unpack_ternary, jwc.pack_ternary,
             jwc.unpack_ternary, q3)):
        b = pack(torch.from_numpy(q))
        assert b.dtype == torch.uint8
        assert_bitwise(b, jpack(jnp.asarray(q)), pack.__name__)
        back = unpack(b, d)
        assert back.dtype == torch.int32
        assert np.array_equal(back.numpy(), q)
        assert np.array_equal(
            back.numpy(), np.asarray(junpack(jnp.asarray(b.numpy()), d)))


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("name", ["int8", "int8_sr"])
def test_quantize_wire_bitwise(name, d):
    w = models(d, 9, d)
    key = jax.random.key(d)
    jq, js, jz = jwc.quantize_wire(jnp.asarray(w), name, key=key)
    q, s, z = pwc.quantize_wire(torch.from_numpy(w), name,
                                key=random.key(d, device="cpu"))
    assert (q.dtype, s.dtype, z.dtype) == (torch.int8, torch.float16,
                                           torch.float16)
    assert_bitwise(q, jq, "q")
    assert_bitwise(s, js, "scale")
    assert_bitwise(z, jz, "zp")
    assert_bitwise(pwc.dequantize_wire(q, s, z),
                   jwc.dequantize_wire(jq, js, jz), "dequantize")


def signed_zero_rows(d: int) -> np.ndarray:
    """Rows whose range is decided by the sign of a zero: -0.0 and +0.0 in
    both orders, all -0.0, all +0.0, a zero beside positives (a zero
    minimum) and beside negatives (a zero maximum), each with the -0.0
    first and last, and a NaN among zeros of both signs."""
    pos = np.arange(d)
    rows = [np.where(pos < d // 2, -0.0, 0.0), np.where(pos < d // 2, 0.0,
                                                       -0.0),
            np.where(pos % 2 == 0, -0.0, 0.0), np.full(d, -0.0),
            np.zeros(d)]
    for sign in (1.0, -1.0):
        for first in (-0.0, 0.0):
            r = np.full(d, sign * 0.5)
            r[0], r[-1] = first, -first
            rows.append(r)
    r = np.where(pos % 2 == 0, -0.0, 0.0)
    r[d // 2] = np.nan
    rows.append(r)
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("d", [2, 7, 10, 32])
@pytest.mark.parametrize("name", ["int8", "int8_sr"])
def test_quantize_wire_orders_signed_zeros_like_jax(name, d):
    """``jnp.min``/``jnp.max`` order -0.0 below +0.0 wherever the zeros
    lie; ``torch.amin``/``amax`` keep whichever comes first. A row of
    mixed-sign zeros must give JAX's zero-point (+0.0, not -0.0), and a
    row's range must not depend on where its zeros are."""
    w = signed_zero_rows(d)
    key = jax.random.key(d)
    jq, js, jz = jwc.quantize_wire(jnp.asarray(w), name, key=key)
    q, s, z = pwc.quantize_wire(torch.from_numpy(w), name,
                                key=random.key(d, device="cpu"))
    assert_bitwise(q, jq, "q")
    assert_bitwise(s, js, "scale")
    assert_bitwise(z, jz, "zp")
    assert not np.signbit(z.numpy()[:3]).any()         # mixed: +0.0
    assert np.signbit(z.numpy()[3])                     # all -0.0: -0.0


def test_int8_sr_needs_a_key_and_takes_noise():
    w = torch.from_numpy(models(0, 4, 10))
    with pytest.raises(ValueError, match="key"):
        pwc.quantize_wire(w, "int8_sr")
    k = random.key(3, device="cpu")
    noise = random.uniform(k, w.shape)
    a = pwc.quantize_wire(w, "int8_sr", key=k)
    b = pwc.quantize_wire(w, "int8_sr", noise=noise)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("name", CODECS)
def test_encode_decode_bitwise(name, d):
    w = models(100 + d, 9, d)
    j, p = jwc.get_codec(name), pwc.get_codec(name)
    kw_j = dict(key=jax.random.key(d)) if j.stochastic else {}
    kw_p = dict(key=random.key(d, device="cpu")) if p.stochastic else {}
    jp, js, jz = j.encode(jnp.asarray(w), **kw_j)
    pp, ps, pz = p.encode(torch.from_numpy(w), **kw_p)
    assert pp.dtype == p.payload_dtype
    assert pp.shape == (9, p.payload_cols(d))
    assert_bitwise(pp.float() if pp.dtype == torch.bfloat16 else pp,
                   np.asarray(jp, np.float32) if pp.dtype == torch.bfloat16
                   else jp, "payload")
    for got, want, lane in ((ps, js, "scale"), (pz, jz, "zp")):
        assert (got is None) == (want is None), lane
        if got is not None:
            assert got.dtype == torch.float16
            assert_bitwise(got, want, lane)
    dec = p.decode(pp, ps, pz, d)
    assert dec.dtype == torch.float32
    assert_bitwise(dec, j.decode(jp, js, jz, d), "decode")
    assert_bitwise(p.roundtrip(torch.from_numpy(w), **kw_p), dec,
                   "roundtrip")


def test_saturation_keeps_scales_finite():
    w = torch.tensor([[1e6, -1e6, 0.0], [7e4, 7e4, 7e4]], dtype=torch.float32)
    for name in ("int8", "int4", "ternary"):
        _, s, z = pwc.get_codec(name).encode(w)
        assert torch.isfinite(s.float()).all(), name
        if z is not None:
            assert torch.isfinite(z.float()).all(), name


# ---------------------------------------------------------------------------
# positional noise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d", [(1, 1), (7, 3), (8, 10), (33, 57),
                                 (5, 9947)])
@pytest.mark.parametrize("seed", [0, 11])
def test_sr_noise_for_rows_equals_the_full_draw(seed, n, d):
    want = np.asarray(jax.random.uniform(jax.random.key(seed), (n, d)))
    k = random.key(seed, device="cpu")
    rows = np.unique(np.random.default_rng(n).integers(0, n, size=4))
    got = random.sr_noise_for_rows(k, torch.from_numpy(rows), d, n)
    assert got.shape == (rows.size, d)
    assert_bitwise(got, want[rows])
    p = torch.arange(n * d, dtype=torch.int64)
    assert_bitwise(random.uniform_at(k, p.reshape(n, d)), want)


def test_uniform_at_splits_the_64_bit_counter():
    """Past 2**32 the counter's high word is ``p >> 32``: hold the port's
    positional uniform to JAX's threefry on that pair (the full draw
    cannot be made at that size here)."""
    from jax._src import prng

    seed = 9
    p = np.array([2 ** 32 - 1, 2 ** 32, 2 ** 32 + 7, 3 * 2 ** 32 + 12345,
                  10 ** 6 * 9947 - 1], dtype=np.int64)
    kd = jax.random.key_data(jax.random.key(seed))
    hi = jnp.asarray((p >> 32).astype(np.uint32))
    lo = jnp.asarray((p & 0xFFFFFFFF).astype(np.uint32))
    b1, b2 = prng.threefry2x32_p.bind(kd[0], kd[1], hi, lo)
    fb = (np.asarray(b1 ^ b2) >> 9) | 0x3F800000
    want = fb.view(np.float32) - np.float32(1.0)
    got = random.uniform_at(random.key(seed, device="cpu"),
                            torch.from_numpy(p))
    assert_bitwise(got, want)
    # and the high word is live: it changes the draw
    low = random.uniform_at(random.key(seed, device="cpu"),
                            torch.from_numpy(p & 0xFFFFFFFF))
    assert not torch.equal(got, low)
