"""The screen's split at d = 5, 6: the port against ``jax.jit``.

At 5 <= d <= 8 XLA sums some of a screen sum's rows unfused, as
``faults.screen_split`` names them (workgroups from the host's CPU count
and the sum's bytes, vectorised rows, a fused scalar tail). This file
holds ``faults._screen_sum`` to ``jnp.sum`` under ``jax.jit`` bit for bit
at d = 5, 6, over the same N and seeds as
``tests/test_torch_screen_split_d78.py`` holds at the other two
widths: the two files are one test's cases, split by d so that each
runs on a worker of its own."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro_torch.core import faults as pf

jit_row_sum = jax.jit(lambda a, b: jnp.sum(a * b, axis=-1))


def as_bytes(a) -> np.ndarray:
    """The raw bytes of an array or tensor (bfloat16 included)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    a = np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8)


# N for the split at 5 <= d <= 8 (faults.screen_split), one workgroup
# unless said: under 16 rows (scalar but at 4 and 8, and at 2 for one
# array at d >= 6), 4-row steps below 32, 8-row or interleaved 4-row
# steps past it with a scalar tail, and at 20 003 / 30 001 / 40 001 two or
# three workgroups on an 8-CPU host (two with N odd: every row scalar)
SPLIT_ROWS = [1, 2, 4, 8, 12, 13, 17, 31, 36, 37, 52, 60, 84, 92, 100, 4099,
              10_083, 20_002, 20_003, 30_001, 40_001]


# every (d, factors, N) but d = 5, N = 2 on one array, where XLA's rows
# follow no split (ROADMAP queue 3)
SPLIT_CASES = [(d, factors, n) for d in (5, 6) for factors in (1, 2)
               for n in SPLIT_ROWS if (d, factors, n) != (5, 1, 2)]


@pytest.mark.parametrize("d,factors,n", SPLIT_CASES)
def test_screen_split_matches_the_jitted_sums(d, factors, n):
    """At 5 <= d <= 8 ``_screen_sum`` sums unfused exactly the rows
    ``screen_split`` names, and equals ``jnp.sum`` of the products under
    ``jax.jit`` bit for bit, for a sum of one array (the squares) and of
    two (the dot), on rows whose fused and unfused sums differ (so every
    row shows which order it took)."""
    rng = np.random.default_rng(1000 * d + n)
    a = rng.normal(size=(4 * n + 64, d)).astype(np.float32)
    b = a if factors == 1 else rng.normal(size=a.shape).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    fused = pf._fused_sum(ta, tb)
    apart = pf._in_sequence(pf._ftz(ta * tb))
    keep = torch.nonzero(fused != apart)[:, 0]
    keep = keep[torch.arange(n) % len(keep)]
    a, b = a[keep.numpy()], b[keep.numpy()]
    ta, tb = torch.from_numpy(a), (ta if factors == 1 else tb)[keep]
    got = pf._screen_sum(ta, ta if factors == 1 else tb)
    want = (jax.jit(lambda u: jnp.sum(u * u, axis=-1))(jnp.asarray(a))
            if factors == 1 else jit_row_sum(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(as_bytes(got), as_bytes(want))
    unfused = pf._unfused_rows(n, d, factors, "cpu").numpy()
    assert np.array_equal(as_bytes(got)[unfused.repeat(4)],
                          as_bytes(apart[keep])[unfused.repeat(4)])
