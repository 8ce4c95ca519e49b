"""The send encode's two routes, on the CPU: the route rule, and the tiled
route's walk and arithmetic emulated in float32.

``kernels/gossip_cycle.py::send_route`` sends every codec at d <= 57 on
16-byte aligned models (and residuals) to the tiled kernels (persistent
blocks walking tiles of R rows through shared memory: a range pass of one
thread a row, then a code pass spread over the tile's flat elements or
output bytes, and under error feedback x = w + ef formed once and a
residual pass over the flat elements) and the rest to the strided kernels
(a warp a row). The kernels run only on the card; here:

- the rule, the rows a tile holds, and a forced route it refuses;
- the tiled walk: every element, noise position and output byte written
  once, at every tile offset a multiple of 16 bytes, including N < R and
  the ragged last tile;
- the tiled kernels' arithmetic (the range pass's min/max with -0.0
  ordered below +0.0, read from each row's own starting column; the codes
  four elements a thread or a byte a thread; the residual four elements a
  thread, every element, byte and scale written once) emulated in PyTorch
  and held
  bit for bit to ``quantize_send_plain`` and to the JAX Pallas kernel in
  interpret mode (for int8_sr, whose Pallas kernel raises under jax's
  partitionable threefry, to ``quantize_wire`` with the same key), on rows
  of mixed-sign zeros, all zeros and NaN.

``chip_smoke.py`` phase 1 and ``tests/test_torch_cuda.py`` hold the two
kernels to each other and to the plain version bit for bit on the card."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire_codec as jwc
from repro.kernels.gossip_cycle import quantize_send as jax_send
from repro_torch import random
from repro_torch.core.wire_codec import get_codec
from repro_torch.kernels import gossip_cycle as gc

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

F32 = torch.float32
THREADS = 256           # the tiled kernels' block
BLOCKS = 3              # persistent blocks in the emulated walk


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("name", smoke.SEND_CODECS)
@pytest.mark.parametrize("d", [1, 7, 10, 32, 57, 58, 128, 9947])
def test_send_route(d, name, aligned):
    """Every codec, the ``_ef`` ones too, takes the tiled route at d <= 57
    on aligned operands."""
    want = "tiled" if d <= 57 and aligned else "strided"
    assert gc.send_route(d, name, aligned) == want
    assert gc.send_route(d, name) == gc.send_route(d, name, True)


@pytest.mark.parametrize("name", ["int4_ef", "ternary_ef"])
def test_send_route_needs_the_residual_aligned_apart_from_the_models(name):
    """Under error feedback the residual's alignment counts apart from the
    models': an aligned ``w`` with an ``ef`` that starts mid-row takes the
    strided route, and the tiled route forced on it is refused before any
    library loads."""
    w, ef = smoke.send_inputs(0, 40, 10, "cpu")
    odd = torch.zeros(41 * 10)[1:401].view(40, 10)   # 4 bytes past 16
    assert w.data_ptr() % 16 == 0 and ef.data_ptr() % 16 == 0
    assert gc.send_aligned(w, ef) and gc.send_aligned(w)
    assert not gc.send_aligned(w, odd) and not gc.send_aligned(odd, ef)
    assert gc.send_route(10, name, gc.send_aligned(w, ef)) == "tiled"
    assert gc.send_route(10, name, gc.send_aligned(w, odd)) == "strided"
    with pytest.raises(ValueError, match="unaligned"):
        gc._launch_send(w, get_codec(name), None, odd, route="tiled")


@pytest.mark.parametrize("d", [1, 7, 10, 16, 32, 33, 57, 100, 128])
def test_send_tile_rows(d):
    """A multiple of 16 rows (every tile offset on a 16-byte boundary), at
    most 256 (one thread a row in the range pass), at most 32 KB of w."""
    r = gc.send_tile_rows(d)
    assert r % 16 == 0 and 16 <= r <= THREADS
    assert 4 * r * d <= 32768
    assert r == THREADS or 4 * (r + 16) * d > 32768
    if d <= 32:
        assert r == THREADS


@pytest.mark.parametrize("d", [1, 7, 10, 16, 17, 32, 57, 128])
def test_send_tile_rows_under_error_feedback(d):
    """A slot holds both tiles (w and ef): a multiple of 16 rows, at most
    256, at most 32 KB of the two together (the rows of the codecs without
    error feedback up to d = 16, fewer past it)."""
    r = gc.send_tile_rows(d, ef=True)
    assert r % 16 == 0 and 16 <= r <= THREADS
    assert 8 * r * d <= 32768
    assert r == THREADS or 8 * (r + 16) * d > 32768
    assert (r == gc.send_tile_rows(d)) == (d <= 16)


def test_send_route_counts_start_at_zero_and_cpu_never_launches():
    assert set(gc.quantize_send.route_launches) == set(gc.SEND_ROUTES)
    before = dict(gc.quantize_send.route_launches)
    w, _ = smoke.send_inputs(0, 40, 10, "cpu")
    for name in ("int8", "ternary"):
        gc.quantize_send(w, name)
    assert gc.quantize_send.route_launches == before


def test_forced_tiled_route_outside_its_range_raises():
    """The override is checked before any library loads: tiled takes no d
    past 128 (with or without error feedback) and no model or residual at
    an unaligned offset."""
    w, ef = smoke.send_inputs(0, 40, 10, "cpu")
    odd_ef = torch.zeros(41 * 10)[1:401].view(40, 10)
    with pytest.raises(ValueError, match="tiled"):
        gc._launch_send(w, get_codec("int4_ef"), None, odd_ef,
                        route="tiled")
    wide = torch.zeros(4, gc.TILED_KERNEL_MAX_WIDTH + 1)
    with pytest.raises(ValueError, match="tiled"):
        gc._launch_send(wide, get_codec("ternary_ef"), None,
                        torch.zeros_like(wide), route="tiled")
    with pytest.raises(ValueError, match="tiled"):
        gc._launch_send(wide, get_codec("ternary"), None, None,
                        route="tiled")
    odd = torch.zeros(41 * 10)[1:401].view(40, 10)   # 4 bytes past 16
    assert odd.data_ptr() % 16 != 0
    assert gc.send_route(10, "ternary", odd.data_ptr() % 16 == 0) \
        == "strided"
    with pytest.raises(ValueError, match="unaligned"):
        gc._launch_send(odd, get_codec("ternary"), None, None, route="tiled")
    with pytest.raises(ValueError, match="warp"):
        gc._launch_send(w, get_codec("int8"), None, None, route="warp")


# ---------------------------------------------------------------------------
# the tiled walk
# ---------------------------------------------------------------------------


def tiles_by_block(n: int, d: int, blocks: int = BLOCKS, ef: bool = False):
    """The tiles each persistent block encodes, in order: tile b, b +
    blocks, ... as (first row, rows); ``ef``: the tiles of the error-feedback
    kernel."""
    r = gc.send_tile_rows(d, ef)
    tiles = -(-n // r)
    return [[(t * r, min(r, n - t * r)) for t in range(b, tiles, blocks)]
            for b in range(blocks)]


def flat_groups(rows: int, d: int):
    """The affine code pass of one tile: thread t's groups of four
    consecutive flat elements e, e + 1, ... (e = 4 t, 4 t + 4 * THREADS,
    ...) cut at the tile's end, each element's (row, column) found from e
    and carried across row ends as the kernel carries it."""
    elems = rows * d
    out = []
    for t in range(THREADS):
        for e in range(4 * t, elems, 4 * THREADS):
            row, col = divmod(e, d)
            group = []
            for i in range(4):
                if e + i < elems:
                    group.append((e + i, row, col))
                col += 1
                if col == d:
                    col, row = 0, row + 1
            out.append((e, group))
    return out


# the population sizes around a tile's R rows: below one tile, one row
# short of it, one tile, one row past it, and many tiles with a ragged one
N_CASES = ["1", "R-1", "R", "R+1", "4099"]


def population(case: str, d: int, ef: bool = False) -> int:
    r = gc.send_tile_rows(d, ef)
    return {"1": 1, "R-1": r - 1, "R": r, "R+1": r + 1, "4099": 4099}[case]


@pytest.mark.parametrize("n", N_CASES)
@pytest.mark.parametrize("d", [1, 7, 10, 32, 57, 128])
def test_tiled_walk_writes_every_element_once(d, n):
    """Every flat element and int8_sr noise position, and every packed
    byte, written once by one tile; tile offsets of w (4 r0 d bytes), of
    the codes (r0 d) and of the packed bytes (r0 cols) multiples of 16; a
    group's float4 read inside its slot and its 4-byte store aligned."""
    n, r = population(n, d), gc.send_tile_rows(d)
    seen = np.zeros(n * d, np.int64)
    seen_bytes = {g: np.zeros(n * -(-d // g), np.int64) for g in (2, 5)}
    walked = [t for block in tiles_by_block(n, d) for t in block]
    assert sorted(r0 for r0, _ in walked) == list(range(0, n, r))
    for r0, rows in walked:
        assert r0 % 16 == 0 and (4 * r0 * d) % 16 == 0
        for e, group in flat_groups(rows, d):
            assert e % 4 == 0 and e + 3 < r * d     # the slot holds r d
            for e_i, row, col in group:
                p = (r0 + row) * d + col              # the noise position
                assert p == r0 * d + e_i and row < rows
                seen[p] += 1
        for g, out in seen_bytes.items():
            cols = -(-d // g)
            assert (r0 * cols) % 16 == 0
            for b in range(rows * cols):
                row, c = divmod(b, cols)
                assert row < rows and c * g < d
                out[(r0 + row) * cols + c] += 1
    assert (seen == 1).all()
    assert all((out == 1).all() for out in seen_bytes.values())


# ---------------------------------------------------------------------------
# the tiled kernels' arithmetic
# ---------------------------------------------------------------------------


def nan_min(a, b):
    """The kernels' ``nan_min``: a where a < b, a is NaN, or a == b and a
    is -0.0 (so -0.0 orders below +0.0), else b."""
    take = (a < b) | a.isnan() | ((a == b) & torch.signbit(a))
    return torch.where(take, a, b)


def nan_max(a, b):
    take = (a > b) | a.isnan() | ((a == b) & ~torch.signbit(a))
    return torch.where(take, a, b)


def sat_f16(v):
    return torch.clamp(v, -65504.0, 65504.0).to(torch.float16)


def guarded(scale):
    """where(scale > 0, scale, 1) in f32: a zero or NaN scale divides by
    one."""
    sf = scale.to(F32)
    return torch.where(sf > 0, sf, torch.ones((), dtype=F32))


def clip_code(u, qmax: float):
    """Clip to [-qmax, qmax]; NaN becomes code 0."""
    return torch.where(u.isnan(), torch.zeros((), dtype=F32),
                       torch.clamp(u, -qmax, qmax)).to(torch.int32)


def range_pass(s, reduce, start):
    """One thread a row: reduce(acc, v) over the row's d elements from
    column r % d on, around the row."""
    rows, d = s.shape
    r = torch.arange(rows)
    acc = start(rows)
    for t in range(d):
        acc = reduce(acc, s[r, (r + t) % d])
    return acc


def div(v, q: float):
    """An IEEE float32 division by a constant (as the kernels divide)."""
    return v / torch.full((), q, dtype=F32)


def tiled_affine8(w, name, key=None):
    """The tiled affine int8 kernel, emulated tile by tile: (q, scale, zp)."""
    n, d = w.shape
    q = torch.full((n * d,), -128, dtype=torch.int8)   # no code is -128
    scale = torch.full((n,), float("nan"), dtype=torch.float16)
    zp = scale.clone()
    for block in tiles_by_block(n, d):
        for r0, rows in block:
            s = w[r0:r0 + rows]
            lo = range_pass(s, nan_min, lambda m: torch.full((m,), np.inf))
            hi = range_pass(s, nan_max, lambda m: torch.full((m,), -np.inf))
            zp_t = sat_f16((hi + lo) * 0.5)
            zpf = zp_t.to(F32)
            sc_t = sat_f16(div(nan_max(hi - zpf, zpf - lo), 126.0))
            sf = guarded(sc_t)
            scale[r0:r0 + rows], zp[r0:r0 + rows] = sc_t, zp_t
            # every thread's groups of the code pass at once
            e, row = (torch.tensor(v) for v in zip(*(
                (e_i, r) for _, group in flat_groups(rows, d)
                for e_i, r, _ in group)))
            u = (s.reshape(-1)[e] - zpf[row]) / sf[row]
            if name == "int8_sr":
                u = torch.floor(u + random.uniform_at(key, r0 * d + e))
            else:
                u = torch.round(u)
            q[r0 * d + e] = clip_code(u, 127.0).to(torch.int8)
    return q.view(n, d), scale, zp


def packed_tile(s, codec):
    """The packed kernels' range and code passes on one tile ``s`` (rows,
    d): the tile's scales (f16), divisors and packed bytes (one a thread,
    the tile's rows ceil(d / G) bytes in order)."""
    rows, d = s.shape
    g, qmax = codec.group, float(codec.qmax)
    cols = codec.payload_cols(d)
    amax = range_pass(s.abs(), nan_max, lambda m: torch.zeros(m))
    sc_t = sat_f16(div(amax, qmax))
    sf = guarded(sc_t)
    b = torch.arange(rows * cols)                     # a thread a byte
    row, c = b // cols, b % cols
    byte = torch.zeros_like(b)
    for k in range(g):
        j = c * g + k
        x = s[row, torch.clamp_max(j, d - 1)]
        code = torch.where(j < d, clip_code(torch.round(x / sf[row]), qmax),
                           0)
        byte = ((byte | ((code & 0xF) << (4 * k))) if g == 2
                else byte + (code + 1) * 3 ** k)
    return sc_t, sf, byte


def tiled_packed(w, name):
    """The tiled packed kernel (no error feedback), emulated tile by tile:
    (payload, scale)."""
    codec = get_codec(name)
    n, d = w.shape
    cols = codec.payload_cols(d)
    payload = torch.full((n * cols,), -1, dtype=torch.int64)
    scale = torch.full((n,), float("nan"), dtype=torch.float16)
    for block in tiles_by_block(n, d):
        for r0, rows in block:
            sc_t, _, byte = packed_tile(w[r0:r0 + rows], codec)
            scale[r0:r0 + rows] = sc_t
            payload[r0 * cols:(r0 + rows) * cols] = byte
    assert (payload >= 0).all()
    return payload.to(torch.uint8).view(n, cols), scale


def tiled_packed_ef(w, ef, name):
    """The tiled packed kernel under error feedback, emulated tile by tile
    on its own tiles (``send_tile_rows(d, ef=True)``): x = w + ef formed
    once, the range and code passes on x, then the residual pass over
    groups of four flat elements a thread, each code recomputed. Returns
    (payload, scale, resid) and how often each residual element was
    written."""
    codec = get_codec(name)
    n, d = w.shape
    qmax = float(codec.qmax)
    cols = codec.payload_cols(d)
    payload = torch.full((n * cols,), -1, dtype=torch.int64)
    scale = torch.full((n,), float("nan"), dtype=torch.float16)
    resid = torch.full((n * d,), float("nan"), dtype=F32)
    written = torch.zeros(n * d, dtype=torch.int64)
    for block in tiles_by_block(n, d, ef=True):
        for r0, rows in block:
            x = w[r0:r0 + rows] + ef[r0:r0 + rows]
            sc_t, sf, byte = packed_tile(x, codec)
            scale[r0:r0 + rows] = sc_t
            payload[r0 * cols:(r0 + rows) * cols] = byte
            e, row = (torch.tensor(v) for v in zip(*(
                (e_i, r) for _, group in flat_groups(rows, d)
                for e_i, r, _ in group)))
            xe = x.reshape(-1)[e]
            code = clip_code(torch.round(xe / sf[row]), qmax)
            resid[r0 * d + e] = xe - code.to(F32) * sc_t.to(F32)[row]
            written[r0 * d + e] += 1
    assert (payload >= 0).all()
    return ((payload.to(torch.uint8).view(n, cols), scale,
             resid.view(n, d)), written)


def tiled_send(w, name, key=None):
    if get_codec(name).has_zp:
        return tiled_affine8(w, name, key)
    return tiled_packed(w, name)


def same_bits(got, want):
    """Equal shape, dtype and bits, a NaN scale or zero-point matching any
    NaN: a NaN's payload is the arithmetic's own (PyTorch's vectorised CPU
    ``maximum`` sets every bit, XLA and the card keep a quiet NaN), and no
    decode reads it."""
    want = (want if isinstance(want, torch.Tensor)
            else torch.from_numpy(np.array(want)))
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    both_nan = (got.isnan() & want.isnan() if got.is_floating_point()
                else torch.zeros(got.shape, dtype=torch.bool))
    g = got.contiguous().view(torch.uint8).view(got.numel(), -1)
    w = want.contiguous().view(torch.uint8).view(want.numel(), -1)
    return bool(((g == w).all(-1) | both_nan.reshape(-1)).all())


def edge_models(n: int, d: int):
    """``chip_smoke.send_inputs``'s models: zero, constant, .5-tie,
    saturating, tiny, mixed-sign zero, all -0.0 and NaN rows, then normal
    ones; below 8 rows, the mixed-sign zero, -0.0 and NaN rows first."""
    w, _ = smoke.send_inputs(n + d, max(n, 8), d, "cpu")
    if n >= 8:
        return w
    return w[[5, 6, 7, 0, 1, 2, 3, 4][:n]]


@pytest.mark.parametrize("n", N_CASES)
@pytest.mark.parametrize("d", [1, 7, 10, 32, 57])
@pytest.mark.parametrize("name", smoke.TILED_CODECS)
def test_tiled_emulation_matches_plain_version(name, d, n):
    """Codes, packed bytes, scales and zero-points bit for bit (``same_bits``),
    at N < R, N = R - 1, R, R + 1 and several tiles with a ragged last
    one."""
    n = population(n, d)
    w = edge_models(n, d)
    key = random.key(n + d, device="cpu")
    k = key if get_codec(name).stochastic else None
    got = tiled_send(w, name, k)
    want = gc.quantize_send_plain(w, name, key=k)
    assert len(got) == len(want)
    for g, p in zip(got, want):
        assert same_bits(g, p)


@pytest.mark.parametrize("d", [1, 7, 10, 32, 57])
@pytest.mark.parametrize("name", smoke.TILED_CODECS)
def test_tiled_emulation_matches_pallas_kernel(name, d):
    """Against ``repro.kernels.gossip_cycle.quantize_send`` in interpret
    mode (for int8_sr against the JAX ``quantize_wire`` with the same key)
    on 300 models, two or three tiles with a ragged last one, mixed-sign
    zero, all-zero and NaN rows among them."""
    n = 300
    w = edge_models(n, d)
    if get_codec(name).stochastic:
        got = tiled_send(w, name, random.key(d, device="cpu"))
        want = jwc.quantize_wire(jnp.asarray(w.numpy()), name,
                                 key=jax.random.key(d))
    else:
        got = tiled_send(w, name)
        want = jax_send(jnp.asarray(w.numpy()), name, interpret=True)
    assert len(got) == len(want)
    for g, p in zip(got, want):
        assert same_bits(g, p)


# ---------------------------------------------------------------------------
# the tiled route under error feedback (int4_ef, ternary_ef)
# ---------------------------------------------------------------------------

EF_CODECS = ("int4_ef", "ternary_ef")


@pytest.mark.parametrize("n", N_CASES)
@pytest.mark.parametrize("d", [1, 7, 10, 32, 57])
def test_tiled_ef_walk_writes_every_element_once(d, n):
    """On the error-feedback kernel's own tiles: every residual element
    (four flat elements a thread), packed byte and scale written once by
    one tile; the tile offsets of w, ef and the residual (4 r0 d bytes) and
    of the packed bytes multiples of 16; a group's float4 read of x and its
    16-byte residual store inside the tile's slot."""
    n, r = population(n, d, ef=True), gc.send_tile_rows(d, ef=True)
    seen = np.zeros(n * d, np.int64)
    seen_scale = np.zeros(n, np.int64)
    seen_bytes = {g: np.zeros(n * -(-d // g), np.int64) for g in (2, 5)}
    walked = [t for block in tiles_by_block(n, d, ef=True) for t in block]
    assert sorted(r0 for r0, _ in walked) == list(range(0, n, r))
    for r0, rows in walked:
        assert r0 % 16 == 0 and (4 * r0 * d) % 16 == 0
        seen_scale[r0:r0 + rows] += 1
        for e, group in flat_groups(rows, d):
            assert e % 4 == 0 and e + 3 < r * d     # the tile holds r d
            for e_i, row, col in group:
                assert (r0 + row) * d + col == r0 * d + e_i and row < rows
                seen[r0 * d + e_i] += 1
        for g, out in seen_bytes.items():
            cols = -(-d // g)
            assert (r0 * cols) % 16 == 0
            out[r0 * cols:(r0 + rows) * cols] += 1
    assert (seen == 1).all() and (seen_scale == 1).all()
    assert all((out == 1).all() for out in seen_bytes.values())


@pytest.mark.parametrize("n", N_CASES)
@pytest.mark.parametrize("d", [1, 7, 10, 32, 57])
@pytest.mark.parametrize("name", EF_CODECS)
def test_tiled_ef_emulation_matches_plain_version(name, d, n):
    """Packed bytes, scales and residuals bit for bit (``same_bits``), each
    residual element written once, at N < R, N = R - 1, R, R + 1 and
    several tiles with a ragged last one, on the edge rows."""
    n = population(n, d, ef=True)
    w = edge_models(n, d)
    _, ef = smoke.send_inputs(n + d + 1, max(n, 8), d, "cpu")
    ef = ef[:n]
    got, written = tiled_packed_ef(w, ef, name)
    assert (written == 1).all()
    want = gc.quantize_send_plain(w, name, ef=ef)
    assert len(got) == len(want) == 3
    for g, p in zip(got, want):
        assert same_bits(g, p)


@pytest.mark.parametrize("d", [1, 7, 10, 32, 57])
@pytest.mark.parametrize("name", EF_CODECS)
def test_tiled_ef_emulation_matches_pallas_kernel(name, d):
    """Against ``repro.kernels.gossip_cycle.quantize_send`` with ``ef`` in
    interpret mode on 300 models (two to five tiles, a ragged last one),
    the edge rows among them."""
    n = 300
    w = edge_models(n, d)
    _, ef = smoke.send_inputs(7 * d, n, d, "cpu")
    got, _ = tiled_packed_ef(w, ef, name)
    want = jax_send(jnp.asarray(w.numpy()), name, ef=jnp.asarray(ef.numpy()),
                    interpret=True)
    assert len(got) == len(want) == 3
    for g, p in zip(got, want):
        assert same_bits(g, p)
