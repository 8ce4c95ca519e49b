"""The receive kernel's two routes, on the CPU: the route rule, and the
grouped route's arithmetic emulated in float32.

``kernels/gossip_cycle.py::receive_route`` sends d <= 32 with K <= 8 to the
grouped kernel (a group of G lanes a node, G the smallest power of two >=
d, every sum an xor butterfly over the group) and the rest to the strided
kernel (a warp a node, 32-lane butterflies). The kernels run only on the
card; here:

- the rule at the widths and round counts around its edges;
- the G-lane and the 32-lane butterflies, emulated lane by lane in
  float32: for d <= G they give the same bits (a zero sum may differ in
  sign), so the three comparisons that read a sum give the same verdicts;
- the grouped kernel's arithmetic (decode, the screen's sums over the
  node's d lanes in the jitted reference's order, fused multiply-adds in
  sequence, the margins' butterflies, the rounds in order
  from registers) emulated in PyTorch and held to
  ``fused_receive_apply_plain`` (integers and gated/clipped counts equal
  on every node, floats within ``chip_smoke.compare_kernel``'s atol 1e-5
  and rtol 1e-5) and to the JAX Pallas kernel in interpret mode (floats
  within ``tests/test_torch_gossip_cycle.py``'s rtol 1e-5 and atol 1e-6).

``chip_smoke.py`` phase 1 and ``tests/test_torch_cuda.py`` hold the two
kernels to each other bit for bit on the card."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire_codec as jwc
from repro.kernels.gossip_cycle import fused_receive_apply as jax_fused
from repro_torch.core import faults
from repro_torch.kernels import gossip_cycle as gc

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

LAM = 1e-3
WARP = 32
F32 = torch.float32


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 4, 8, 9])
@pytest.mark.parametrize("d", [1, 2, 10, 16, 17, 32, 33, 57, 9947])
def test_receive_route(d, k):
    want = "grouped" if d <= 32 and k <= 8 else "strided"
    assert gc.receive_route(d, k) == want
    assert want in gc.RECEIVE_ROUTES


def test_receive_route_counts_start_at_zero_and_cpu_never_launches():
    """The CPU takes the plain version and launches nothing, on any
    route."""
    a = smoke.receive_inputs(0, 37, 10, 3, 4, "cpu")
    gc.fused_receive_apply(*(a[key] for key in smoke.ORDER), variant="mu",
                           lam=LAM)
    assert gc.fused_receive_apply.launches == 0
    assert gc.fused_receive_apply.route_launches == dict.fromkeys(
        gc.RECEIVE_ROUTES, 0)


def test_forced_grouped_route_outside_its_range_raises():
    """The private override cannot send K = 9 or d = 33 to the grouped
    kernel; the check comes before any library is loaded."""
    for d, k in ((33, 4), (10, 9)):
        a = smoke.receive_inputs(1, 8, d, 3, k, "cpu")
        with pytest.raises(ValueError, match="grouped"):
            gc._launch_receive(*(a[key] for key in smoke.ORDER), None, None,
                               "f32", "mu", LAM, "none", route="grouped")
    with pytest.raises(ValueError, match="warp"):
        gc._launch_receive(*(a[key] for key in smoke.ORDER), None, None,
                           "f32", "mu", LAM, "none", route="warp")


# ---------------------------------------------------------------------------
# the butterflies
# ---------------------------------------------------------------------------


def group(d: int) -> int:
    """The grouped kernel's lanes a node: the smallest power of two >= d."""
    g = 1
    while g < d:
        g *= 2
    return g


def butterfly(v, g: int):
    """(..., 32) float32 lanes -> each lane's xor-butterfly sum over its
    aligned group of g lanes, levels o = g/2 ... 1, each lane adding its
    partner's partial to its own (``v += __shfl_xor_sync(.., v, o)``)."""
    lanes = torch.arange(WARP)
    o = g // 2
    while o:
        v = v + v[..., lanes ^ o]
        o //= 2
    return v


def lane_partials(terms, d: int):
    """The per-lane partial sums of one node's d terms as the kernels hold
    them at d <= 32: lane j < d holds ``0.0f + term j``, the rest +0.0."""
    out = torch.zeros(terms.shape[:-1] + (WARP,), dtype=F32)
    out[..., :d] = 0.0 + terms
    return out


def tricky_terms(rng, nodes: int, d: int):
    """(nodes, d) float32 terms with ±0.0, subnormals, ±inf, nan, huge
    values (whose sums overflow) and ordinary ones, in seeded places."""
    pool = np.array([0.0, -0.0, 1e-40, -1e-40, 1.4e-45, np.inf, -np.inf,
                     np.nan, 3e38, -3e38, 1.0, -1.0], dtype=np.float32)
    t = rng.standard_normal((nodes, d)).astype(np.float32)
    pick = rng.random((nodes, d)) < 0.3
    t[pick] = rng.choice(pool, size=int(pick.sum()))
    t[:8] = 0.0                       # all-zero nodes
    t[8:16] = -0.0
    t[16:24] = rng.choice(pool[:5], size=(8, d))   # zeros and subnormals
    return torch.from_numpy(t)


def grouped_lanes(terms, g: int):
    """(nodes, d) terms in the grouped layout: node q on lanes q g ... q g
    + d - 1 of its warp, zeros elsewhere -> (warps, 32)."""
    nodes, d = terms.shape
    lanes = torch.zeros(nodes, g, dtype=F32)
    lanes[:, :d] = terms
    return lanes.view(-1, WARP)


def same_bits(a, b):
    """Equal bits, or both zeros of any sign, or both nan (the card's
    float adds return one canonical nan)."""
    ai, bi = a.view(torch.int32), b.view(torch.int32)
    return (ai == bi) | ((a == 0) & (b == 0)) | (a.isnan() & b.isnan())


@pytest.mark.parametrize("d", [1, 2, 3, 7, 10, 16, 17, 31, 32])
def test_group_butterfly_equals_warp_butterfly(d):
    """For d <= G the G-lane tree and the 32-lane tree give the same bits;
    with every partial starting at +0.0 (as the kernels' do) even a zero
    sum has the same sign, and only raw -0.0 partials can give a zero of
    the other sign. Every lane of a group holds the sum."""
    g = group(d)
    rng = np.random.default_rng(d)
    nodes = 64 * (WARP // g)
    terms = tricky_terms(rng, nodes, d)
    strided = butterfly(lane_partials(terms, d), WARP)[:, 0]
    # the grouped layout: WARP // g nodes a warp, node q on lanes q g ...
    summed = butterfly(grouped_lanes(0.0 + terms, g), g).view(nodes, g)
    grouped = summed[:, 0]
    assert bool(same_bits(summed, grouped[:, None]).all())
    nan = grouped.isnan()
    assert torch.equal(nan, strided.isnan())
    assert torch.equal(grouped.view(torch.int32)[~nan],
                       strided.view(torch.int32)[~nan])
    assert bool((grouped[~nan].view(torch.int32) != -2**31).all())  # no -0
    # raw partials, -0.0 included: equal up to the sign of a zero sum
    raw = torch.zeros(nodes, WARP, dtype=F32)
    raw[:, :d] = terms
    raw_g = butterfly(grouped_lanes(terms, g), g).view(nodes, g)[:, 0]
    raw_s = butterfly(raw, WARP)[:, 0]
    assert bool(same_bits(raw_g, raw_s).all())
    differ = raw_g.view(torch.int32) != raw_s.view(torch.int32)
    assert bool((raw_g[differ] == 0).all() | raw_g[differ].isnan().all())


@pytest.mark.parametrize("d", [1, 7, 10, 16, 32])
def test_sums_read_by_verdicts_agree_between_trees(d):
    """``margin < 1``, norm_clip's ``sq > thr`` and cosine_gate's ``dot <
    -0.2 sqrt(sq rn)``: the same verdicts from either tree's sums."""
    g = group(d)
    rng = np.random.default_rng(100 + d)
    nodes = 256
    m, lw, x = (tricky_terms(rng, nodes, d) for _ in range(3))
    y = torch.from_numpy(np.where(rng.random(nodes) < 0.5, -1.0, 1.0)
                         .astype(np.float32))
    ftz = faults._ftz

    def sums(tree_g):
        def tree(terms):
            return butterfly(grouped_lanes(0.0 + terms, tree_g),
                             tree_g).view(nodes, tree_g)[:, 0]
        mj, lj = ftz(m), ftz(lw)
        return (tree(m * x), tree(ftz(mj * mj)), tree(ftz(lj * lj)),
                tree(ftz(mj * lj)))

    verdicts = []
    for tree_g in (g, WARP):
        a, sq, rn, dot = sums(tree_g)
        thr = torch.clamp_min(faults.NORM_CLIP_MULT_SQ * rn,
                              faults.NORM_CLIP_FLOOR_SQ)
        verdicts.append((
            y * a < 1.0, ~torch.isfinite(sq), sq > thr,
            (rn > faults.COSINE_GATE_MIN_NORM_SQ)
            & (dot < faults.COSINE_GATE_THRESHOLD_F32
               * torch.sqrt(ftz(sq * rn)))))
    for a, b in zip(*verdicts):
        assert torch.equal(a, b)
    assert any(v.any() and not v.all() for v in verdicts[0])


# ---------------------------------------------------------------------------
# the grouped kernel's arithmetic
# ---------------------------------------------------------------------------


def decoded(inputs, wire, d):
    """The (K, N, d) messages as the kernel's ``unpack`` decodes them."""
    mode = gc._wire_mode(wire, inputs.get("msg_scale"), inputs.get("msg_zp"))
    return gc._decode_msg(inputs["msg_w"], inputs.get("msg_scale"),
                          inputs.get("msg_zp"), d, mode)


def pegasos_step(t, margin, y, lam):
    """``pegasos_step`` of the kernel, per node: (t + 1, decay, hinge,
    coef)."""
    t1 = t + 1
    eta = 1.0 / (lam * t1.to(F32))
    return t1, 1.0 - eta * lam, margin < 1.0, eta * y


def apply_step(step, w, x):
    _, decay, hinge, coef = step
    return decay[:, None] * w + torch.where(hinge[:, None],
                                            coef[:, None] * x, 0.0)


def screen_sum(a, b, on, d: int):
    """The kernels' screen sums at d <= 32 (``screen_sums``): lane j < d of
    a node holds its two factors where ``on`` (+0.0 elsewhere), read in
    lane order and added in the jitted reference's order (fused
    multiply-adds in sequence from +0.0, the products apart at d = 5 ...
    8 on the rows ``faults.screen_split`` names for a sum of one array,
    the squares, or of two, the dot), as ``faults._screen_sum`` adds
    them."""
    zero = torch.zeros((), dtype=F32)
    return faults._screen_sum(torch.where(on, a, zero)[:, :d],
                              torch.where(on, b, zero)[:, :d],
                              1 if a is b else 2)


def grouped_receive(inputs, variant, lam, wire=None, defense="none"):
    """The grouped kernel, emulated: each node on g lanes (coefficient j on
    lane j, lanes >= d hold 0), the screen's sums over the node's d lanes
    in the jitted reference's order and the margins g-lane butterflies of partials that
    start at +0.0, the rounds in order with the running lastModel held as
    the screened message of the latest accepted round. Returns the six
    state tensors (new), the gated and clipped counts, and the nodes where
    a screen's verdict differs from the plain version's
    (``faults.apply_defense`` on the same message and lastModel), which
    sums in the same order and so should have none, exact ties included."""
    a = {k: v.clone() for k, v in inputs.items()}
    n, c, d = a["cache_w"].shape
    k = a["msg_w"].shape[0]
    g = group(d)
    msgs = decoded(a, wire, d)
    lam = torch.tensor(lam, dtype=F32)
    lane_on = torch.arange(g) < d

    def lanes(v):               # (N, d) -> (N, g), zero past d
        out = torch.zeros(n, g, dtype=F32)
        out[:, :d] = v
        return out

    def tree(partials, on):     # partials where on, +0.0 elsewhere
        v = torch.where(on, 0.0 + partials, torch.zeros((), dtype=F32))
        per_warp = torch.zeros(-(-n * g // WARP) * WARP, dtype=F32)
        per_warp[:n * g] = v.reshape(-1)
        return butterfly(per_warp.view(-1, WARP), g).view(-1)[
            :n * g].view(n, g)[:, 0]

    ftz, rows = faults._ftz, torch.arange(n)
    x, y = lanes(a["x"]), a["y"]
    lcur = lanes(a["last_w"])
    p, cnt, lt = a["ptr"].clone(), a["count"].clone(), a["last_t"].clone()
    got = torch.zeros(n, dtype=torch.bool)
    ties = torch.zeros(n, dtype=torch.bool)
    gated = torch.zeros(n, dtype=torch.int32)
    clipped = torch.zeros_like(gated)
    for r in range(k):
        act = a["valid"][r] > 0
        raw = lanes(msgs[r])
        mj = raw
        if defense != "none":
            on = act[:, None] & lane_on
            mf, lf = ftz(raw), ftz(lcur)
            sq = screen_sum(mf, mf, on, d)
            rn = screen_sum(lf, lf, on, d)
            reject = ~torch.isfinite(sq)
            if defense == "norm_clip":
                thr = torch.clamp_min(faults.NORM_CLIP_MULT_SQ * rn,
                                      faults.NORM_CLIP_FLOOR_SQ)
                clip = ~reject & (sq > thr)
                f = torch.sqrt(ftz(thr / torch.clamp_min(
                    sq, faults.CLIP_SQ_GUARD)))
                clipped += (act & clip).to(torch.int32)
                mj = torch.where(clip[:, None], ftz(ftz(raw) * f[:, None]),
                                 raw)
            else:
                dot = screen_sum(mf, lf, on, d)
                reject |= (rn > faults.COSINE_GATE_MIN_NORM_SQ) & (
                    dot < faults.COSINE_GATE_THRESHOLD_F32
                    * torch.sqrt(ftz(sq * rn)))
            seq = faults.apply_defense(defense, raw[:, :d], act,
                                       lcur[:, :d])
            ties |= (seq[2] != (act & reject)) | (
                seq[3] != (act & clip if defense == "norm_clip" else
                           torch.zeros_like(act)))
            gated += (act & reject).to(torch.int32)
            act = act & ~reject
        use = act[:, None] & lane_on
        mt = a["msg_t"][r]
        if variant == "mu":
            w = (mj + lcur) / 2.0
            step = pegasos_step(torch.maximum(mt, lt), y * tree(w * x, use),
                                y, lam)
            out, nt = apply_step(step, w, x), step[0]
        elif variant == "um":
            s1 = pegasos_step(mt, y * tree(mj * x, use), y, lam)
            s2 = pegasos_step(lt, y * tree(lcur * x, use), y, lam)
            out = (apply_step(s1, mj, x) + apply_step(s2, lcur, x)) / 2.0
            nt = torch.maximum(s1[0], s2[0])
        else:
            step = pegasos_step(mt, y * tree(mj * x, use), y, lam)
            out, nt = apply_step(step, mj, x), step[0]
        slot = (p % c).long()
        r_, s_ = rows[act], slot[act]
        a["cache_w"][r_, s_] = out[act][:, :d]
        a["cache_t"][r_, s_] = nt[act]
        inc = act.to(torch.int32)
        p += inc
        cnt = torch.where(act, torch.clamp_max(cnt + 1, c), cnt)
        lcur = torch.where(act[:, None], mj, lcur)
        lt = torch.where(act, mt, lt)
        got |= act
    a["last_w"][got] = lcur[got][:, :d]
    a["last_t"][got] = lt[got]
    a["ptr"][got] = p[got]
    a["count"][got] = cnt[got]
    return [a[key] for key in smoke.STATE], gated, clipped, ties


# (d, C, K): one and several groups a warp, K > C, and K = 8
SHAPES = [(1, 10, 4), (7, 3, 5), (10, 10, 4), (16, 3, 5), (32, 10, 8)]
CASES = ([(mode, wire, "none") for mode, wire in
          (("f32", None), *smoke.DECODE_WIRES.items())]
         + [(mode, wire, defense) for defense in smoke.DEFENSE_MODES
            for mode, wire in (("f32", None), *smoke.SCREEN_WIRES.items())])


@pytest.mark.parametrize("d,c,k", SHAPES)
@pytest.mark.parametrize("mode,wire,defense", CASES)
@pytest.mark.parametrize("variant", ["rw", "mu", "um"])
def test_grouped_emulation_matches_plain_version(variant, mode, wire,
                                                 defense, d, c, k):
    """On ``chip_smoke.receive_inputs`` (rows crafted for every verdict
    under a screen): integer state and counts equal, float state within
    atol 1e-5 and rtol 1e-5, on every node. The screen's verdicts equal the
    plain version's on every node and round, exact ties included (on the
    packed wires a cosine of exactly -0.2 is reachable): both sum in the
    jitted reference's order at d <= 32 (fused multiply-adds in sequence
    from +0.0)."""
    crafted = defense != "none"
    inputs = smoke.receive_inputs(d * 31 + k, 64 * group(d), d, c, k, "cpu",
                                  wire=wire, crafted=crafted)
    state, gated, clipped, ties = grouped_receive(inputs, variant, LAM, wire,
                                                  defense)
    b = {key: v.clone() for key, v in inputs.items()}
    want = gc.fused_receive_apply_plain(
        *(b[key] for key in smoke.ORDER),
        **{key: b[key] for key in smoke.META if key in b}, wire=wire,
        variant=variant, lam=LAM, defense=defense)
    assert not ties.any()
    assert torch.equal(gated, want[6])
    assert torch.equal(clipped, want[7])
    if crafted:
        assert int(gated.sum()) > 0
        assert (int(clipped.sum()) > 0) == (defense == "norm_clip")
    for key, got, w in zip(smoke.STATE, state, want[:6]):
        if key in smoke.INT_FIELDS:
            assert torch.equal(got, w), key
        else:
            assert torch.isfinite(got).all(), key
            torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-5,
                                       msg=key)


def jax_inputs(seed, n, d, c, k):
    """A mid-run state made with numpy, as the JAX tests make it."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    i = lambda lo, hi, *s: rng.integers(lo, hi, size=s).astype(np.int32)
    return dict(
        last_w=f(n, d), last_t=i(0, 40, n), cache_w=f(n, c, d),
        cache_t=i(0, 40, n, c), ptr=i(1, 3 * c, n), count=i(1, c + 1, n),
        msg_w=f(k, n, d) * 3, msg_t=i(0, 40, k, n),
        valid=(rng.random((k, n)) < 0.6).astype(np.int32),
        x=f(n, d), y=np.where(rng.random(n) < 0.5, -1.0, 1.0)
        .astype(np.float32))


@pytest.mark.parametrize("d", [7, 10, 32])
@pytest.mark.parametrize("wire", [None, "int4"])
@pytest.mark.parametrize("variant", ["rw", "mu", "um"])
def test_grouped_emulation_matches_pallas_kernel(variant, wire, d):
    """Against ``repro.kernels.gossip_cycle.fused_receive_apply`` in
    interpret mode (as ``tests/test_torch_gossip_cycle.py`` runs it):
    integer state equal, floats within rtol 1e-5 and atol 1e-6."""
    c, k, n = 3, 5, 37
    inp = jax_inputs(17 * d + len(variant), n, d, c, k)
    payload, msc = jnp.asarray(inp["msg_w"]), None
    if wire is not None:
        payload, msc, _ = jwc.get_codec(wire).encode(payload)
    ours = {key: torch.from_numpy(np.array(v)) for key, v in inp.items()}
    ours["msg_w"] = torch.from_numpy(np.array(payload))
    if msc is not None:
        ours["msg_scale"] = torch.from_numpy(np.array(msc))
    state, _, _, _ = grouped_receive(ours, variant, LAM, wire)

    j = {key: jnp.asarray(v) for key, v in inp.items()}
    out = jax_fused(j["last_w"], j["last_t"], j["cache_w"], j["cache_t"],
                    j["ptr"], j["count"], payload, j["msg_t"], j["valid"],
                    j["x"], j["y"], msg_scale=msc, wire=wire,
                    variant=variant, lam=LAM, interpret=True)
    for key, got, w in zip(smoke.STATE, state, out[:6]):
        w = np.asarray(w)
        if w.dtype == np.int32:
            assert np.array_equal(got.numpy(), w), key
        else:
            np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-6,
                                       err_msg=key)
