"""The subset apply's screen at 5 <= d <= 8: the port against the jitted
reference chunk.

At these widths XLA sums the rows its vector loop takes unfused, and which
rows those are depends on the row count of the sum (``faults.screen_split``).
The reference's compact paths apply the receives to a gathered subset of
the packed width W, not to all N nodes, so the port's subset apply must
take the split of W rows. One cycle of the port's ``run_chunk`` under
``compact_all`` and ``compact`` (the receive kernel's plain version on the
gathered rows) against the JAX package's jitted chunk function of the same
packing, from the same carry and tables: lastModel (the screened, possibly
rescaled message, whose bits norm_clip's rescale takes from the sums) and
every integer lane, and the chunk's gated and clipped counts, bit for bit;
the cached weights hold the Pegasos step, which XLA fuses and the port
rounds as the Pallas kernel does, so they are held to rtol 1e-5 and atol
1e-6, as ``tests/test_torch_screen_order.py`` holds them."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sharded_engine as jse
from repro_torch import convert
from repro_torch.core import sharded_engine as pse

N, C, D, K = 200, 4, 3, 3

# (d, W): widths where XLA's split of W rows differs from N's (W = 13 and
# 24 take no vector loop or a 4-row one, 40-96 the vector loop over most
# rows)
CASES = [(d, w) for d, w in ((5, 24), (6, 13), (6, 40), (7, 88), (8, 13),
                              (8, 96))]


def carry_arrays(rng, d):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    i = lambda lo, hi, *s: rng.integers(lo, hi, size=s).astype(np.int32)
    cw, ct = f(N, C, d), i(0, 30, N, C)
    ptr, cnt = i(1, 3 * C, N), i(1, C + 1, N)
    slot = (ptr - 1) % C
    return (f(N, d) * 0.3, i(0, 30, N), cw[np.arange(N), slot],
            ct[np.arange(N), slot], cw, ct, ptr, cnt, f(D, N, d) * 3.0,
            i(0, 30, D, N), np.zeros((0, 0), np.float16),
            np.zeros((0, 0), np.float16), np.zeros((0, 0), np.float32),
            np.int32(7))


def tables(rng, mode, width):
    """One cycle's packed tables: ``width`` receivers (ascending, the last
    few padding), their K rounds filled in order; messages from buffer
    rows 0 and 2, which this cycle (clock 7, row 1) does not write."""
    real = width - 3
    ridx = np.full((1, width), -1, np.int32)
    ridx[0, :real] = np.sort(rng.choice(N, size=real, replace=False))
    depth = rng.integers(1, K + 1, size=width)
    slots = np.where(rng.random((K, width)) < 0.5, 0, 2) * N \
        + rng.integers(0, N, size=(K, width))
    rslot = np.where((np.arange(K)[:, None] < depth[None, :])
                     & (ridx[0] >= 0)[None, :], slots, -1).astype(np.int32)
    if mode == "compact_all":
        sidx = np.arange(0, N, 3, dtype=np.int32)[None, :]
        return (ridx, rslot[None], sidx), (np.array([real]),
                                           np.array([sidx.shape[1]]))
    src0 = np.where(rng.random(N) < 0.7, rng.integers(0, N, size=N), -1)
    src0[ridx[0, :real]] = rslot[0, :real]      # round 1 of the receivers
    return (src0[None].astype(np.int32), ridx, rslot[None, 1:]), (
        np.array([real]),)


@pytest.mark.parametrize("defense", ["norm_clip", "cosine_gate"])
@pytest.mark.parametrize("mode", ["compact_all", "compact"])
@pytest.mark.parametrize("d,width", CASES)
def test_subset_screen_equals_the_jitted_chunk(d, width, mode, defense):
    rng = np.random.default_rng(d * 100 + width)
    carry = carry_arrays(rng, d)
    tabs, counts = tables(rng, mode, width)
    X = rng.normal(size=(N, d)).astype(np.float32)
    y = np.where(rng.random(N) < 0.5, -1.0, 1.0).astype(np.float32)
    fn = jse._build_chunk_fn("mu", "pegasos", 1e-3, 0.01, D, False, False,
                             None, None, mode, None, False, None, defense)
    jout, (_, (jg, jc)) = fn(
        tuple(jnp.asarray(a) for a in carry),
        tuple(jnp.asarray(a) for a in tabs), jnp.zeros((1, 2), jnp.uint32),
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(X[:4]),
        jnp.asarray(y[:4]), jnp.arange(4), None)
    want = dict(zip(convert.CARRY_FIELDS, (np.asarray(a) for a in jout)))
    pc = convert.state_from_arrays(carry, "cpu")
    _, screen = pse.run_chunk(
        pc, mode, [torch.from_numpy(a) for a in tabs], torch.from_numpy(X),
        torch.from_numpy(y), variant="mu", lam=1e-3, counts=counts,
        defense=defense)
    got = dict(zip(convert.CARRY_FIELDS, convert.to_arrays(pc)))
    assert screen.tolist() == [int(jg), int(jc)]
    assert int(jg) + int(jc) > 0
    assert np.array_equal(got["last_w"].view(np.int32),
                          want["last_w"].view(np.int32))
    for name in ("last_t", "cache_t", "ptr", "count", "fresh_t", "buf_t"):
        assert np.array_equal(got[name], want[name]), name
    for name in ("cache_w", "fresh_w", "buf_w"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
