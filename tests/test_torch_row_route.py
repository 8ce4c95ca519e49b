"""The row kernels' two layouts (kernels #6 and #7, ``csrc/pegasos_merge.cu``),
on the CPU: the route rule, and the tiled kernels' walk and arithmetic
emulated in float32.

``kernels/pegasos_update.py::row_route`` sends the step (#6) and the merge
(#7) at d <= 57 on 16-byte aligned operands to the tiled layout
(persistent blocks walking tiles of R rows of the model(s), x, the
counter(s) and y through shared memory: an element pass forming the model
(the merge's halved sum) and the margin's products, a row pass summing
them in j order from +0.0, an element pass writing w') and the rest to the
strided layout (a warp a row, a block a row at d >= 1024). The kernels run
only on the card; here:

- the rule, the rows a tile holds, and a forced layout it refuses;
- the tiled walk: every row (t') and every element (w') written once,
  each tile's offsets on 16-byte boundaries, the products' odd pitch;
- the tiled kernels' arithmetic emulated in PyTorch and held to the plain
  versions ``ref.pegasos_update_ref`` and ``ref.merge_update_ref`` and to
  the JAX Pallas kernels in interpret mode at ``chip_smoke.compare_rows``'
  tolerance (rtol 2e-5, atol 1e-5, t' equal): only the margin's order
  differs, so w' is bitwise equal but in a row whose margin lies within
  that sum's rounding of 1.

``chip_smoke.py`` phase 1 and ``tests/test_torch_cuda.py`` hold the two
layouts to each other and to the plain version on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gossip_merge as jgm
from repro.kernels import pegasos_update as jpu
from repro_torch.kernels import gossip_merge as gm
from repro_torch.kernels import pegasos_update as pu
from repro_torch.kernels import ref

F32 = torch.float32
THREADS = 256           # the tiled kernel's block
BLOCKS = 3              # persistent blocks in the emulated walk
LAM = 1e-3


def rows(seed, n, d):
    """(w1, t1, w2, t2, x, y) as tensors, made with numpy, as
    ``chip_smoke.row_inputs`` makes them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        out += [rng.standard_normal((n, d), dtype=np.float32),
                rng.integers(0, 100, n, dtype=np.int32)]
    out += [rng.standard_normal((n, d), dtype=np.float32),
            np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)]
    return tuple(torch.from_numpy(a) for a in out)


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("d", [1, 7, 10, 32, 57, 58, 128, 1024, 9947])
def test_row_route(d, merge, aligned):
    """The merge and the step alone each take the tiled layout at d <= 57
    on aligned operands (the widest width of chip_smoke.py's sweep at which
    the tiled layout beat the strided one on an H100), the strided one
    otherwise."""
    want = "tiled" if d <= 57 and aligned else "strided"
    assert pu.row_route(d, merge, aligned) == want
    assert pu.row_route(d, merge) == pu.row_route(d, merge, True)


@pytest.mark.parametrize("d", [1, 7, 10, 32, 57, 100, 128])
def test_merge_tile_rows(d):
    """A multiple of 16 rows (every tile offset on a 16-byte boundary), 16
    to 256 (one thread a row in the row pass), at most 16 KB of w1, w2, x,
    t1, t2 and y but where 16 rows take more."""
    r = pu.merge_tile_rows(d)
    row_bytes = 4 * (3 * d + 3)
    assert r % 16 == 0 and 16 <= r <= THREADS
    assert r == 16 or r * row_bytes <= 16384
    assert r == THREADS or r == 16 or (r + 16) * row_bytes > 16384


@pytest.mark.parametrize("d", [1, 7, 10, 32, 57, 100, 128])
def test_step_tile_rows(d):
    """As for the merge, with w, x, t and y a row: 176 rows at d = 10."""
    r = pu.step_tile_rows(d)
    row_bytes = 4 * (2 * d + 2)
    assert r % 16 == 0 and 16 <= r <= THREADS
    assert r == 16 or r * row_bytes <= 16384
    assert r == THREADS or r == 16 or (r + 16) * row_bytes > 16384
    assert pu.step_tile_rows(10) == 176


def test_row_route_counts_start_at_zero_and_cpu_never_launches():
    for fn in (pu.pegasos_update, gm.merge_update):
        assert set(fn.route_launches) == set(pu.ROW_ROUTES)
    before = (dict(pu.pegasos_update.route_launches),
              dict(gm.merge_update.route_launches))
    w1, t1, w2, t2, x, y = rows(0, 40, 10)
    gm.merge_update(w1, t1, w2, t2, x, y, lam=LAM)
    pu.pegasos_update(w1, t1, x, y, lam=LAM)
    assert (pu.pegasos_update.route_launches,
            gm.merge_update.route_launches) == before


def test_forced_tiled_merge_outside_its_range_raises():
    """The override is checked before any library loads: the tiled layout
    takes no d past 128 and no operand at an unaligned offset."""
    wide = rows(1, 4, pu.TILED_KERNEL_MAX_WIDTH + 1)
    with pytest.raises(ValueError, match="tiled"):
        gm._launch_merge(wide, 4, wide[0].shape[1], LAM, route="tiled")
    w1, t1, w2, t2, x, y = rows(2, 40, 10)
    odd = torch.zeros(41 * 10)[1:401].view(40, 10)   # 4 bytes past 16
    assert odd.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="unaligned"):
        gm._launch_merge((w1, t1, w2, t2, odd, y), 40, 10, LAM,
                         route="tiled")
    with pytest.raises(ValueError, match="warp"):
        gm._launch_merge((w1, t1, w2, t2, x, y), 40, 10, LAM, route="warp")


def test_forced_tiled_step_outside_its_range_raises():
    """The same for the step: no d past 128, no unaligned operand."""
    w, t, _, _, x, y = rows(3, 4, pu.TILED_KERNEL_MAX_WIDTH + 1)
    with pytest.raises(ValueError, match="tiled"):
        pu._launch_step((w, t, x, y), 4, w.shape[1], LAM, route="tiled")
    w, t, _, _, x, y = rows(4, 40, 10)
    odd = torch.zeros(41 * 10)[1:401].view(40, 10)   # 4 bytes past 16
    with pytest.raises(ValueError, match="unaligned"):
        pu._launch_step((odd, t, x, y), 40, 10, LAM, route="tiled")
    with pytest.raises(ValueError, match="warp"):
        pu._launch_step((w, t, x, y), 40, 10, LAM, route="warp")


# ---------------------------------------------------------------------------
# the tiled walk
# ---------------------------------------------------------------------------


def tiles_by_block(n: int, d: int, blocks: int = BLOCKS, merge=True):
    """The tiles each persistent block works on, in order: tile b, b +
    blocks, ... as (first row, rows), of the merge's tiles or the step's."""
    r = (pu.merge_tile_rows if merge else pu.step_tile_rows)(d)
    tiles = -(-n // r)
    return [[(t * r, min(r, n - t * r)) for t in range(b, tiles, blocks)]
            for b in range(blocks)]


def store_groups(rows: int, d: int):
    """The w' pass of one tile: thread t's groups of four consecutive flat
    elements e, e + 1, ... (e = 4 t, 4 t + 4 * THREADS, ...) cut at the
    tile's end, each element's row found from e and carried across row
    ends as the kernel carries it."""
    elems = rows * d
    out = []
    for t in range(THREADS):
        for e in range(4 * t, elems, 4 * THREADS):
            row, col = divmod(e, d)
            group = []
            for i in range(4):
                if e + i < elems:
                    group.append((e + i, row))
                col += 1
                if col == d:
                    col, row = 0, row + 1
            out.append((e, group))
    return out


N_CASES = ["1", "R-1", "R", "R+1", "4099"]


def population(case: str, d: int, merge=True) -> int:
    r = (pu.merge_tile_rows if merge else pu.step_tile_rows)(d)
    return {"1": 1, "R-1": r - 1, "R": r, "R+1": r + 1, "4099": 4099}[case]


def walk_touches_every_row_and_element_once(d, n, merge):
    """Every row's t' and every element's w' written once by one tile; the
    tile offsets of the (N, d) operands (4 r0 d bytes) and of the (N,) ones
    (4 r0 bytes) multiples of 16; a group's float4 reads inside its tile
    and its 16-byte store aligned; the products' pitch odd and at least
    d."""
    n = population(n, d, merge)
    r = (pu.merge_tile_rows if merge else pu.step_tile_rows)(d)
    seen = np.zeros(n * d, np.int64)
    seen_rows = np.zeros(n, np.int64)
    walked = [t for block in tiles_by_block(n, d, merge=merge)
              for t in block]
    assert sorted(r0 for r0, _ in walked) == list(range(0, n, r))
    pitch = d | 1
    assert pitch % 2 == 1 and d <= pitch <= d + 1
    for r0, rows_ in walked:
        assert (4 * r0 * d) % 16 == 0 and (4 * r0) % 16 == 0
        seen_rows[r0:r0 + rows_] += 1           # a thread a row
        for e, group in store_groups(rows_, d):
            assert e % 4 == 0 and e + 3 < r * d
            for e_i, row in group:
                assert row < rows_ and e_i // d == row
                seen[r0 * d + e_i] += 1
    assert (seen == 1).all() and (seen_rows == 1).all()


@pytest.mark.parametrize("n", N_CASES)
@pytest.mark.parametrize("d", [1, 7, 10, 32, 57, 128])
def test_tiled_merge_walk_touches_every_row_and_element_once(d, n):
    walk_touches_every_row_and_element_once(d, n, merge=True)


@pytest.mark.parametrize("n", N_CASES)
@pytest.mark.parametrize("d", [1, 7, 10, 32, 57, 128])
def test_tiled_step_walk_touches_every_row_and_element_once(d, n):
    walk_touches_every_row_and_element_once(d, n, merge=False)


# ---------------------------------------------------------------------------
# the tiled merge's arithmetic
# ---------------------------------------------------------------------------


def tiled_rows(w1, t1, w2, t2, x, y, lam):
    """The tiled kernel, emulated tile by tile in float32: the model (the
    merge's (w1 + w2) / 2, or w1 where w2 is None: the step) and the
    margin's products a flat element at a time, the margin summed in j
    order from +0.0 a row at a time, then w' = decay m + [hinge] (eta y) x.
    Returns (w', t') and how often each element of w' was written."""
    merge = w2 is not None
    n, d = w1.shape
    w_out = torch.full((n * d,), float("nan"), dtype=F32)
    t_out = torch.full((n,), -1, dtype=torch.int32)
    written = torch.zeros(n * d, dtype=torch.int64)
    lam32 = torch.tensor(lam, dtype=F32)
    for block in tiles_by_block(n, d, merge=merge):
        for r0, rows_ in block:
            sl = slice(r0, r0 + rows_)
            m = (w1[sl] + w2[sl]) / 2.0 if merge else w1[sl]
            prod = m * x[sl]
            acc = torch.zeros(rows_, dtype=F32)
            for j in range(d):
                acc = acc + prod[:, j]
            t = (torch.maximum(t1[sl], t2[sl]) if merge else t1[sl]) + 1
            eta = 1.0 / (lam32 * t.to(F32))
            decay, coef = 1.0 - eta * lam32, eta * y[sl]
            hinge = y[sl] * acc < 1.0
            t_out[sl] = t
            e, row = (torch.tensor(v) for v in zip(*(
                (e_i, r) for _, group in store_groups(rows_, d)
                for e_i, r in group)))
            mf, xf = m.reshape(-1)[e], x[sl].reshape(-1)[e]
            w_out[r0 * d + e] = decay[row] * mf + torch.where(
                hinge[row], coef[row] * xf, torch.zeros((), dtype=F32))
            written[r0 * d + e] += 1
    return (w_out.view(n, d), t_out), written


def tiled_merge(w1, t1, w2, t2, x, y, lam):
    """The tiled merge kernel, emulated (``tiled_rows``)."""
    return tiled_rows(w1, t1, w2, t2, x, y, lam)


def tiled_step(w, t, x, y, lam):
    """The tiled step kernel, emulated (``tiled_rows`` without w2, t2)."""
    return tiled_rows(w, t, None, None, x, y, lam)


def assert_rows(got, want):
    """``chip_smoke.compare_rows``' tolerance: t' equal, w' within rtol
    2e-5 and atol 1e-5."""
    w, t = (torch.as_tensor(np.array(a)) for a in want)
    assert torch.equal(got[1], t)
    torch.testing.assert_close(got[0], w, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("n", N_CASES)
@pytest.mark.parametrize("d", [1, 7, 10, 32, 57])
def test_tiled_merge_emulation_matches_plain_version(d, n):
    """Against ``ref.merge_update_ref`` on the same inputs, each element of
    w' written once."""
    n = population(n, d)
    inputs = rows(n + d, n, d)
    got, written = tiled_merge(*inputs, LAM)
    assert (written == 1).all()
    assert_rows(got, ref.merge_update_ref(*inputs, LAM))


@pytest.mark.parametrize("d", [1, 7, 10, 32, 57])
def test_tiled_merge_emulation_matches_pallas_kernel(d):
    """Against ``repro.kernels.gossip_merge.merge_update`` in interpret
    mode (as ``tests/test_torch_kernels_ops.py`` runs it) on 300 rows,
    several tiles and a ragged last one."""
    inputs = rows(7 * d, 300, d)
    got, _ = tiled_merge(*inputs, LAM)
    want = jgm.merge_update(*(jnp.asarray(a.numpy()) for a in inputs),
                            lam=LAM, interpret=True)
    assert_rows(got, want)


def step_rows(seed, n, d):
    """(w, t, x, y) as ``chip_smoke.row_inputs`` makes them."""
    w, t, _, _, x, y = rows(seed, n, d)
    return w, t, x, y


@pytest.mark.parametrize("n", N_CASES)
@pytest.mark.parametrize("d", [1, 7, 10, 32, 57])
def test_tiled_step_emulation_matches_plain_version(d, n):
    """Against ``ref.pegasos_update_ref`` on the same inputs, each element
    of w' written once."""
    n = population(n, d, merge=False)
    inputs = step_rows(n + d, n, d)
    got, written = tiled_step(*inputs, LAM)
    assert (written == 1).all()
    assert_rows(got, ref.pegasos_update_ref(*inputs, LAM))


@pytest.mark.parametrize("d", [1, 7, 10, 32, 57])
def test_tiled_step_emulation_matches_pallas_kernel(d):
    """Against ``repro.kernels.pegasos_update.pegasos_update`` in interpret
    mode on 300 rows (two tiles of 176 at d = 10, the last ragged), each
    element of w' written once, and against the plain version."""
    inputs = step_rows(11 * d, 300, d)
    got, written = tiled_step(*inputs, LAM)
    assert (written == 1).all()
    want = jpu.pegasos_update(*(jnp.asarray(a.numpy()) for a in inputs),
                              lam=LAM, interpret=True)
    assert_rows(got, want)
    assert_rows(got, ref.pegasos_update_ref(*inputs, LAM))
