"""The voted-predict kernel's two routes (kernel #5,
``csrc/voted_predict.cu``), on the CPU: the route rule, and the grouped
route's score tree and answers emulated in float32.

``kernels/voted_predict.py::voted_route`` sends d <= 32 (C <= 256) to the
grouped route (G = 2^ceil(log2 d) lanes score one (query, slot) pair, lane
j holding +0.0 + w_j x_j and zeros past d, the score a G-lane xor
butterfly from offset G / 2, the votes of the slots below the node's count
a ballot) and the rest to the strided route (a warp a query, each score a
32-lane xor butterfly over the same products). The kernels run only on
the card; here:

- the rule and the forced route it refuses;
- the G-lane tree against the 32-lane tree at every d from 1 to 32: equal
  bits but for the sign of a zero sum, which ``score >= 0`` does not see;
- the grouped route's answers, emulated, against the plain version
  ``voted_predict_batched_plain`` and the JAX Pallas kernel in interpret
  mode on gathered rows: C d not a multiple of 4, counts below C, and the
  zero-score, exact-tie and below-tie rows of ``chip_smoke.voted_inputs``.

``chip_smoke.py`` phases 1 and 5 and ``tests/test_torch_cuda.py`` hold the
two routes to each other and to the plain version on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import voted_predict as jvp
from repro_torch.kernels import voted_predict as vp

F32 = torch.float32
WARP = 32


def voted_inputs(seed, m, c, d):
    """As ``chip_smoke.voted_inputs`` makes them, on the CPU: a snapshot of
    M nodes and M queries, counts in [1, C], node 0 all zero (every score
    0, answered +1), nodes 1 and 2 an exact tie (+1), node 3 one vote in
    four (-1), queries 0-3 on nodes 0-3."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((m, c, d), dtype=np.float32)
    count = rng.integers(1, c + 1, size=m, dtype=np.int32)
    X = rng.standard_normal((m, d), dtype=np.float32)
    assign = rng.integers(0, m, size=m, dtype=np.int32)
    assign[:4] = np.arange(4)
    w[0] = 0.0
    for node in (1, 2):
        count[node] = 2
        w[node, 0], w[node, 1] = X[node], -X[node]
    count[3] = 4
    w[3, 0], w[3, 1:4] = X[3], -X[3]
    return tuple(torch.from_numpy(a) for a in (w, count, X, assign))


def group(d: int) -> int:
    """G, the grouped route's lanes a (query, slot) pair."""
    return 1 << (d - 1).bit_length()


def butterfly(v, width: int):
    """An xor butterfly over the last axis of ``v`` (``width`` lanes),
    from offset width / 2: every lane ends holding the tree's sum."""
    lane = torch.arange(width)
    o = width // 2
    while o:
        v = v + v[..., lane ^ o]
        o //= 2
    return v


def lane_products(w, x, width: int):
    """(..., width) lanes: +0.0 + w_j x_j on lane j < d, +0.0 past d."""
    d = w.shape[-1]
    out = torch.zeros(w.shape[:-1] + (width,), dtype=F32)
    out[..., :d] = 0.0 + w * x
    return out


def scores(w, X, width: int):
    """Each (query, slot)'s score on ``width`` lanes: lane 0 of the tree."""
    return butterfly(lane_products(w, X[:, None, :], width), width)[..., 0]


def grouped_answers(w, count, X, assign):
    """The grouped route, emulated: the node's rows gathered (the kernel's
    load of its C d floats), the G-lane scores, the votes of the slots
    below its count, p_ratio and the answer."""
    a = assign.long()
    wq, cnt = w[a], count[a]
    c, d = w.shape[1:]
    votes = (scores(wq, X, group(d)) >= 0) & (torch.arange(c) < cnt[:, None])
    pos = votes.sum(-1).to(F32)
    p_ratio = pos / torch.clamp_min(cnt, 1).to(F32)
    return torch.where(p_ratio - 0.5 >= 0, 1.0, -1.0)


@pytest.mark.parametrize("c", [1, 10, 256, 257])
@pytest.mark.parametrize("d", [1, 2, 10, 17, 32, 33, 57, 9947])
def test_voted_route(d, c):
    """Grouped at d <= 32 and C <= 256, strided otherwise."""
    want = "grouped" if d <= 32 and c <= 256 else "strided"
    assert vp.voted_route(d, c) == want
    assert vp.voted_route(d) == vp.voted_route(d, 10)


@pytest.mark.parametrize("c,d,want", [(10, 10, 160), (10, 1, 32),
                                      (3, 5, 32), (10, 17, 320),
                                      (256, 32, 1024), (7, 9, 128)])
def test_grouped_lanes_all(c, d, want):
    """Threads a query with all its slots' groups at once: C G rounded up
    to whole warps, at most 1024 (the groups then take turns)."""
    assert group(d) * c <= want or want == 1024
    assert vp.grouped_lanes_all(c, d) == want


def test_forced_grouped_route_outside_its_range_raises():
    """The override is checked before any library loads."""
    w, count, X, assign = voted_inputs(0, 8, 10, 33)
    with pytest.raises(ValueError, match="grouped"):
        vp._launch(w, count, X, assign, route="grouped")
    with pytest.raises(ValueError, match="warp"):
        vp._launch(w, count, X, assign, route="warp")


def test_route_counts_start_at_zero_and_cpu_never_launches():
    assert set(vp.voted_predict_batched.route_launches) == set(
        vp.VOTED_ROUTES)
    before = dict(vp.voted_predict_batched.route_launches)
    vp.voted_predict_batched(*voted_inputs(1, 16, 10, 10))
    assert vp.voted_predict_batched.route_launches == before


@pytest.mark.parametrize("d", range(1, 33))
def test_group_tree_equals_the_32_lane_tree(d):
    """The G-lane butterfly and the strided route's 32-lane one on the same
    products: equal (bit for bit but for the sign of a zero sum) and so
    the same verdict ``score >= 0``, on random rows, all-zero rows, rows
    that cancel to zero, and rows of one nonzero product."""
    rng = np.random.default_rng(d)
    w = torch.from_numpy(rng.standard_normal((512, 3, d), dtype=np.float32))
    X = torch.from_numpy(rng.standard_normal((512, d), dtype=np.float32))
    w[:8] = 0.0
    w[8:16, 0] = X[8:16]
    w[8:16, 1] = -X[8:16]
    w[16:24, :, 1:] = 0.0
    w[24:32] *= 1e-30
    g, s32 = scores(w, X, group(d)), scores(w, X, WARP)
    assert torch.equal(g == s32, torch.ones_like(g, dtype=torch.bool))
    nonzero = s32 != 0
    assert torch.equal(g[nonzero].view(torch.int32),
                       s32[nonzero].view(torch.int32))
    assert torch.equal(g >= 0, s32 >= 0)
    assert bool((s32[:8] == 0).all())


# (M, C, d): C d a multiple of 4 (16-byte loads) and not (4-byte loads);
# counts below C in every case (drawn in [1, C]; C >= 4 for the crafted
# rows)
VOTED_CASES = [(256, 10, 10), (97, 10, 7), (64, 5, 5), (40, 10, 32),
               (33, 7, 1), (50, 5, 16), (45, 10, 17)]


@pytest.mark.parametrize("m,c,d", VOTED_CASES)
def test_grouped_answers_equal_plain_and_pallas(m, c, d):
    """The grouped route's answers, emulated, equal the plain version's on
    the snapshot and the Pallas kernel's (interpret mode) on the gathered
    rows, bit for bit; the zero-score and tie rows answer +1, the
    below-tie row -1."""
    w, count, X, assign = voted_inputs(m + c + d, m, c, d)
    got = grouped_answers(w, count, X, assign)
    a = assign.long()
    plain = vp.voted_predict_batched_plain(w[a], count[a], X)
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
    pallas = np.asarray(jvp.voted_predict_batched(
        jnp.asarray(w[a].numpy()), jnp.asarray(count[a].numpy()),
        jnp.asarray(X.numpy()), interpret=True))
    assert np.array_equal(got.numpy().view(np.int32), pallas.view(np.int32))
    assert got[:4].tolist() == [1.0, 1.0, 1.0, -1.0]
    assert bool((count < c).any())
