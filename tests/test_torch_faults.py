"""Byzantine faults and the defense screens: the port against the JAX
package.

``random.fold_in``, ``byzantine_mask``, ``corrupt_model`` and
``bitflip_payload`` must equal the reference bit for bit (numpy inputs
handed to both packages). ``apply_defense``'s verdicts (surviving mask,
gated, clipped) must be equal and its rescaled messages within 1e-6
relative; its sums must equal ``jnp.sum`` under ``jax.jit`` bit for bit
(the order the reference's engines run: fused multiply-adds at most
d <= 32, two halves at 33-64, 32-wide chunks at multiples of 32), and
with them norm_clip's rescaled messages (the split at 5 <= d <= 8 and
the engine's ``apply_receives`` are held to ``jax.jit`` in
``tests/test_torch_screen_split_d56.py``, ``..._d78.py`` and
``tests/test_torch_screen_order.py``). The
receive step's plain version with each defense must match the Pallas
kernel in interpret mode (integer state and counts equal, floats within
``rtol=1e-5, atol=1e-6`` as in ``tests/test_torch_gossip_cycle.py``). Both port engines must match the
JAX reference engine under every fault: economy and ``fault_stats`` exact,
curves within 0.02. The JAX compact_all and Pallas engine legs are no
oracle here (ROADMAP.md queue 3); the reference engine is."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.gossip_linear import GossipLinearConfig as JConfig
from repro.core import faults as jf
from repro.core import wire_codec as jwc
from repro.core.cache import ModelCache as JCache
from repro.core.cache import cache_oldest as jax_cache_oldest
from repro.core.simulation import run_simulation as jax_run
from repro.data.synthetic import make_linear_dataset
from repro.kernels.gossip_cycle import fused_receive_apply as jax_fused
from repro_torch import random
from repro_torch.configs.gossip_linear import GossipLinearConfig
from repro_torch.core import faults as pf
from repro_torch.core.cache import ModelCache, cache_oldest
from repro_torch.core.simulation import run_simulation
from repro_torch.kernels import gossip_cycle as pgc

CURVE_TOL = 0.02
MODEL_FAULTS = [n for n, f in jf.FAULT_MODELS.items() if f.kind == "model"]


def tkey(kd) -> torch.Tensor:
    """Raw uint32 key words as the port's int64 key."""
    return torch.tensor(np.asarray(kd, np.uint32).astype(np.int64))


def jkey(kd):
    return jax.random.wrap_key_data(np.asarray(kd, np.uint32))


def key_words(seed):
    return np.random.default_rng(seed).integers(0, 2 ** 32, size=2,
                                                dtype=np.uint64)


def to_torch(a) -> torch.Tensor:
    """A numpy or JAX array as a tensor of its own dtype (bfloat16 by its
    bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def as_bytes(a) -> np.ndarray:
    """The raw bytes of an array or tensor (bfloat16 included)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    a = np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8)


# ---------------------------------------------------------------------------
# keys, registry, mask
# ---------------------------------------------------------------------------


def test_fold_in_bitwise_over_keys_and_data():
    keys = [key_words(s) for s in range(12)] + [np.array([0, 0]),
                                                np.array([2 ** 32 - 1] * 2)]
    data = [0, 1, 7, jf.FAULT_FOLD, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
    stack = torch.stack([tkey(k) for k in keys])
    for d in data:
        want = np.stack([np.asarray(jax.random.key_data(
            jax.random.fold_in(jkey(k), d))) for k in keys])
        assert np.array_equal(random.fold_in(stack, d).numpy(),
                              want.astype(np.int64)), d
        assert np.array_equal(random.fold_in(stack[3], d).numpy(),
                              want[3].astype(np.int64))
    # fault_key of a stack of cycle keys, one call
    want = np.stack([np.asarray(jax.random.key_data(jf.fault_key(jkey(k))))
                     for k in keys])
    assert np.array_equal(pf.fault_key(stack).numpy(), want.astype(np.int64))


def test_registry_constants_and_checks_equal_the_reference():
    assert {n: (f.kind, f.description) for n, f in pf.FAULT_MODELS.items()} \
        == {n: (f.kind, f.description) for n, f in jf.FAULT_MODELS.items()}
    assert list(pf.FAULT_MODELS) == list(jf.FAULT_MODELS)
    assert pf.DEFENSES == jf.DEFENSES
    for name in ("FAULT_FOLD", "BYZANTINE_STREAM_TAG", "SIGN_FLIP_GAMMA",
                 "AMPLIFY_GAMMA", "NORM_CLIP_MULT", "NORM_CLIP_FLOOR",
                 "COSINE_GATE_THRESHOLD", "COSINE_GATE_MIN_NORM"):
        assert getattr(pf, name) == getattr(jf, name), name
    # the squared constants: a Python double rounded to float32 once
    assert pf.COSINE_GATE_MIN_NORM_SQ == float(np.float32(
        jf.COSINE_GATE_MIN_NORM ** 2))
    assert pf.NORM_CLIP_MULT_SQ == float(np.float32(jf.NORM_CLIP_MULT ** 2))
    assert pf.get_fault(None) is None and pf.get_fault("") is None
    assert pf.get_fault("zero") is pf.FAULT_MODELS["zero"]
    with pytest.raises(ValueError, match="unknown fault model"):
        pf.get_fault("gaussian")
    assert pf.check_defense("cosine_gate") == "cosine_gate"
    with pytest.raises(ValueError, match="unknown defense"):
        pf.check_defense("median")


@pytest.mark.parametrize("seed,n,frac", [(0, 1000, 0.1), (5, 64, 1.0),
                                         (7, 33, 0.0), (3, 20_000, 0.1),
                                         (11, 101, 0.37)])
def test_byzantine_mask_equal(seed, n, frac):
    assert np.array_equal(pf.byzantine_mask(seed, n, frac),
                          jf.byzantine_mask(seed, n, frac))


def test_cache_oldest_equal():
    rng = np.random.default_rng(1)
    n, c, d = 23, 4, 5
    w = rng.normal(size=(n, c, d)).astype(np.float32)
    t = rng.integers(0, 50, size=(n, c)).astype(np.int32)
    ptr = rng.integers(1, 12, size=n).astype(np.int32)
    cnt = rng.integers(1, c + 1, size=n).astype(np.int32)
    jw, jt = jax_cache_oldest(JCache(*(jnp.asarray(a) for a in
                                       (w, t, ptr, cnt))))
    pw, pt = cache_oldest(ModelCache(*(torch.from_numpy(a) for a in
                                       (w, t, ptr, cnt))))
    assert np.array_equal(pw.numpy(), np.asarray(jw))
    assert np.array_equal(pt.numpy(), np.asarray(jt))


# ---------------------------------------------------------------------------
# corruptions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("name", MODEL_FAULTS)
def test_corrupt_model_bitwise(name, subset):
    """Dense, and the ``rows=`` subset form against the rows of the dense
    JAX result (the reference's own subset form raises under jax's
    partitionable threefry: ROADMAP.md queue 3)."""
    n, d = 37, 13
    rng = np.random.default_rng(len(name))
    w = (rng.normal(size=(n, d)) * 3).astype(np.float32)
    w[0] = 0.0
    t = rng.integers(0, 90, size=n).astype(np.int32)
    old_w = rng.normal(size=(n, d)).astype(np.float32)
    old_t = rng.integers(0, 9, size=n).astype(np.int32)
    byz = rng.random(n) < 0.4
    kd = key_words(42)
    rows = np.array([30, 0, 5, 36, 11, 12], np.int64) if subset else None
    sel = (lambda a: a[rows]) if subset else (lambda a: a)
    jw, jt = jf.corrupt_model(
        jf.get_fault(name), jnp.asarray(byz), jf.fault_key(jkey(kd)),
        jnp.asarray(w), jnp.asarray(t), jnp.asarray(old_w),
        jnp.asarray(old_t))
    jw, jt = sel(np.asarray(jw)), sel(np.asarray(jt))
    pw, pt = pf.corrupt_model(
        pf.get_fault(name), torch.from_numpy(sel(byz)),
        pf.fault_key(tkey(kd)), torch.from_numpy(sel(w)),
        torch.from_numpy(sel(t)), torch.from_numpy(sel(old_w)),
        torch.from_numpy(sel(old_t)),
        rows=None if rows is None else torch.from_numpy(rows),
        n_total=n if subset else None)
    assert np.array_equal(as_bytes(pw), as_bytes(jw))
    assert np.array_equal(pt.numpy(), np.asarray(jt))
    with pytest.raises(ValueError, match="not a model-kind"):
        pf.corrupt_model(pf.get_fault("bitflip"), torch.from_numpy(byz),
                         pf.fault_key(tkey(kd)), torch.from_numpy(w),
                         torch.from_numpy(t))


@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("wire,d", [("f32", 7), ("bf16", 9), ("f16", 13),
                                    ("int8", 11), ("int4", 13),
                                    ("ternary", 7)])
def test_bitflip_payload_bitwise(wire, d, subset):
    """Every codec's payload dtype (f32, bf16, f16, int8, packed uint8) at
    odd widths, on rows encoded by the JAX codec; dense and ``rows=``."""
    n = 41
    rng = np.random.default_rng(d)
    w = (rng.normal(size=(n, d)) * 2).astype(np.float32)
    payload = jwc.get_codec(wire).encode(jnp.asarray(w))[0]
    byz = rng.random(n) < 0.5
    kd = key_words(d)
    rows = np.array([40, 2, 19, 0, 7], np.int64) if subset else None
    sel = (lambda a: a[rows]) if subset else (lambda a: a)
    # the subset form against the rows of the dense JAX result (its own
    # subset form raises under the partitionable threefry)
    want = jf.bitflip_payload(jnp.asarray(byz), jf.fault_key(jkey(kd)),
                              payload)
    if subset:
        want = want[jnp.asarray(rows)]
    got = pf.bitflip_payload(
        torch.from_numpy(sel(byz)), pf.fault_key(tkey(kd)),
        to_torch(payload)[torch.from_numpy(rows)] if subset
        else to_torch(payload),
        rows=None if rows is None else torch.from_numpy(rows),
        n_total=n if subset else None)
    assert got.dtype == to_torch(want).dtype
    assert np.array_equal(as_bytes(got), as_bytes(want))
    # exactly one bit flipped in each Byzantine row, none elsewhere
    before = as_bytes(to_torch(payload)[torch.from_numpy(rows)] if subset
                      else to_torch(payload))
    flips = np.unpackbits(before ^ as_bytes(got), axis=-1).sum(axis=-1)
    assert np.array_equal(flips, sel(byz).astype(int))


# ---------------------------------------------------------------------------
# the screen
# ---------------------------------------------------------------------------


def screen_cases(n=48, d=9, seed=0):
    """Messages and lastModels reaching every verdict: oversized (clip),
    small (pass), anti-aligned (cosine gate), non-finite, a zero
    lastModel (the floor), subnormal coefficients (flushed, as the
    reference's arithmetic flushes them), invalid rows."""
    rng = np.random.default_rng(seed)
    recv = rng.normal(size=(n, d)).astype(np.float32)
    msg = (rng.normal(size=(n, d)) * 3).astype(np.float32)
    msg[0:4] *= 100.0
    msg[4:8] *= 0.01
    msg[8:12] = -recv[8:12]
    msg[12, 0] = np.inf
    msg[13, 3] = np.nan
    msg[14, :] = -np.inf
    recv[16:20] = 0.0
    msg[16:18] = 0.05
    msg[20:24] = np.where(recv[20:24] > 0, -1e-40, 1e-40)
    msg[24] = 1e-20                                 # squares underflow
    valid = rng.random(n) < 0.8
    valid[:25] = True
    return msg, valid, recv


@pytest.mark.parametrize("defense", ["none", "norm_clip", "cosine_gate"])
def test_apply_defense_matches_jax(defense):
    for seed in range(3):
        msg, valid, recv = screen_cases(seed=seed)
        jm, jv, jg, jc = jf.apply_defense(defense, jnp.asarray(msg),
                                          jnp.asarray(valid),
                                          jnp.asarray(recv))
        pm, pv, pg, pc = pf.apply_defense(defense, torch.from_numpy(msg),
                                          torch.from_numpy(valid),
                                          torch.from_numpy(recv))
        for got, want in ((pv, jv), (pg, jg), (pc, jc)):
            assert np.array_equal(got.numpy(), np.asarray(want))
        keep = np.asarray(jv)
        np.testing.assert_allclose(pm.numpy()[keep], np.asarray(jm)[keep],
                                   rtol=1e-6, atol=0)
    if defense == "norm_clip":
        assert np.asarray(jc)[:4].all() and np.asarray(jg)[12:15].all()
    if defense == "cosine_gate":
        assert np.asarray(jg)[8:15].all() and not np.asarray(jg)[20:25].any()


# the widths whose order the screen takes from the jitted reference: the
# one term, fused multiply-adds, the unfused widths 5 ... 8, two halves,
# and 32-wide chunks
SCREEN_WIDTHS = [1, 7, 10, 32, 33, 57, 64, 128]
jit_row_sum = jax.jit(lambda a, b: jnp.sum(a * b, axis=-1))
jit_defense = jax.jit(jf.apply_defense, static_argnums=0)


@pytest.mark.parametrize("d", SCREEN_WIDTHS)
def test_screen_sums_equal_jnp_sum_bitwise(d):
    """The screen sums in the order of the jitted reference (the engines
    run ``apply_defense`` inside ``jax.jit``, where XLA fuses the products
    into the sum at most widths): equal to ``jnp.sum`` under ``jax.jit``
    bit for bit on rows of squares and of products of both signs, zeros
    of both signs among them."""
    rng = np.random.default_rng(d)
    m = (rng.normal(size=(4000, d)) * 3).astype(np.float32)
    r = rng.normal(size=(4000, d)).astype(np.float32)
    m[:8] = -0.0
    r[8:16] = np.where(np.arange(d) % 2 == 0, -0.0, 0.0)
    for a, b in ((m, m), (r, r), (m, r), (-m, r)):
        want = jit_row_sum(jnp.asarray(a), jnp.asarray(b))
        got = pf._screen_sum(torch.from_numpy(a), torch.from_numpy(b))
        assert np.array_equal(as_bytes(got), as_bytes(want))


@pytest.mark.parametrize("d", [2, 10, 32, 57, 64, 96])
def test_screen_sums_flush_like_the_jitted_reference(d):
    """Subnormals under fusion: the reference flushes the inputs and each
    fused result, not a product that is never rounded. Rows of products
    in the subnormal range, sums near the smallest normal, subnormal
    inputs, the ``screen_cases`` row of 1e-20 and near-cancelling dots."""
    rng = np.random.default_rng(200 + d)
    n = 3000
    a = rng.normal(size=(n, d)).astype(np.float32)
    b = rng.normal(size=(n, d)).astype(np.float32)
    tiny = np.float32(2.0) ** rng.integers(-80, -50, size=(1000, 1))
    a[:1000] *= tiny.astype(np.float32)
    b[:1000] *= tiny.astype(np.float32)
    a[1000:1500, 0] = 1e-40
    b[1500:2000, d // 2] = -3e-39
    a[2000:2500] = 1e-20
    b[2000:2500] = 1e-20
    b[2500:] = a[2500:] * (1 + 1e-7 * rng.normal(size=(500, d))
                           ).astype(np.float32)
    a[2500:, ::2] *= -1
    for x, y in ((a, a), (b, b), (a, b)):
        want = jit_row_sum(jnp.asarray(x), jnp.asarray(y))
        got = pf._screen_sum(pf._ftz(torch.from_numpy(x)),
                             pf._ftz(torch.from_numpy(y)))
        assert np.array_equal(as_bytes(got), as_bytes(want))
    assert np.asarray(jit_row_sum(jnp.asarray(a[2000:2500]),
                                  jnp.asarray(a[2000:2500]))).max() == 0.0


@pytest.mark.parametrize("d", SCREEN_WIDTHS)
def test_norm_clip_rescale_equals_jax_bitwise(d):
    """With ``sq`` and ``rn`` summed in the jitted reference's order,
    norm_clip's factor sqrt(thr / sq), and every rescaled coefficient,
    equal the jitted reference's bit for bit, and so do cosine_gate's
    verdicts."""
    rng = np.random.default_rng(50 + d)
    recv = rng.normal(size=(4000, d)).astype(np.float32)
    msg = (rng.normal(size=(4000, d)) * 20).astype(np.float32)
    valid = np.ones(4000, bool)
    for defense in ("norm_clip", "cosine_gate"):
        jm, jv, jg, jc = jit_defense(defense, jnp.asarray(msg),
                                     jnp.asarray(valid), jnp.asarray(recv))
        pm, pv, pg, pc = pf.apply_defense(defense, torch.from_numpy(msg),
                                          torch.from_numpy(valid),
                                          torch.from_numpy(recv))
        for got, want in ((pv, jv), (pg, jg), (pc, jc)):
            assert np.array_equal(got.numpy(), np.asarray(want))
        assert np.array_equal(as_bytes(pm), as_bytes(jm))
        if defense == "norm_clip":
            assert np.asarray(jc).mean() > 0.5


def crafted_inputs(seed, n, d, c, k):
    """A mid-run receive state whose first rows reach every verdict of the
    screen, including an oversized (clipped) message followed by more
    valid rounds, which merge against the rescaled lastModel."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    i = lambda lo, hi, *s: rng.integers(lo, hi, size=s).astype(np.int32)
    inp = dict(
        last_w=f(n, d), last_t=i(0, 40, n), cache_w=f(n, c, d),
        cache_t=i(0, 40, n, c), ptr=i(1, 3 * c, n), count=i(1, c + 1, n),
        msg_w=f(k, n, d) * 3, msg_t=i(0, 40, k, n),
        valid=(rng.random((k, n)) < 0.6).astype(np.int32), x=f(n, d),
        y=np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32))
    inp["valid"][:, :16] = 1
    inp["msg_w"][0, 0:4] *= 100.0                  # clip, then more rounds
    inp["msg_w"][0, 4:8] = -inp["last_w"][4:8]     # anti-aligned
    inp["last_w"][8:12] = 0.0                      # the floor
    inp["msg_w"][0, 8:10] = 0.05
    inp["msg_w"][0, 12, 0] = np.inf                # non-finite
    inp["msg_w"][1, 13, 2] = np.nan
    return inp


ORDER = ("last_w", "last_t", "cache_w", "cache_t", "ptr", "count", "msg_w",
         "msg_t", "valid", "x", "y")


# each defense after each variant and each decode family (f32, affine
# int8, int4), the wires rotating across the variants
SCREEN_CASES = [(defense, variant, (None, "int8", "int4")[(i + j) % 3])
                for i, defense in enumerate(("norm_clip", "cosine_gate"))
                for j, variant in enumerate(("rw", "mu", "um"))]


@pytest.mark.parametrize("defense,variant,wire", SCREEN_CASES)
def test_plain_receive_with_defense_matches_the_pallas_kernel(defense,
                                                              variant, wire):
    n, d, c, k, lam = 37, 10, 3, 4, 1e-3
    inp = crafted_inputs(3, n, d, c, k)
    payload, msc, mzp = jnp.asarray(inp["msg_w"]), None, None
    if wire is not None:
        payload, msc, mzp = jwc.get_codec(wire).encode(payload)
        # non-finite messages through the f16 scale of a quantized wire
        msc = msc.at[0, 12].set(jnp.inf).at[1, 13].set(jnp.nan)
    j = {key: jnp.asarray(v) for key, v in inp.items()}
    jout = jax_fused(j["last_w"], j["last_t"], j["cache_w"], j["cache_t"],
                     j["ptr"], j["count"], payload, j["msg_t"], j["valid"],
                     j["x"], j["y"], msg_scale=msc, msg_zp=mzp, wire=wire,
                     variant=variant, lam=lam, interpret=True,
                     defense=defense)
    args = [torch.tensor(inp[key]) for key in ORDER]
    args[6] = to_torch(payload)
    kw = dict(wire=wire, variant=variant, lam=lam, defense=defense)
    if msc is not None:
        kw["msg_scale"] = to_torch(msc)
    if mzp is not None:
        kw["msg_zp"] = to_torch(mzp)
    before = pgc.fused_receive_apply.launches
    out = pgc.fused_receive_apply(*args, **kw)
    assert pgc.fused_receive_apply.launches == before     # CPU: plain
    assert len(out) == 8
    for got, want in zip(out, jout):
        want = np.asarray(want)
        if want.dtype == np.int32:
            assert np.array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-6)
    gated, clipped = out[6].numpy(), out[7].numpy()
    assert gated[12:14].all()                     # non-finite rows
    if defense == "norm_clip":
        assert clipped[:4].all()
    else:
        assert gated[4:8].all() and not clipped.any()


def test_plain_receive_without_defense_is_unchanged():
    """``defense="none"`` returns zero counts and the state of the
    unscreened step."""
    inp = crafted_inputs(5, 29, 6, 4, 3)
    inp["msg_w"][np.isnan(inp["msg_w"]) | np.isinf(inp["msg_w"])] = 1.0
    a = [torch.tensor(inp[key]) for key in ORDER]
    b = [torch.tensor(inp[key]) for key in ORDER]
    out = pgc.fused_receive_apply(*a, variant="mu", lam=1e-3)
    ref = pgc.fused_receive_apply_plain(*b, variant="mu", lam=1e-3,
                                        defense="none")
    for got, want in zip(out, ref):
        assert torch.equal(got, want)
    assert not out[6].any() and not out[7].any()


# ---------------------------------------------------------------------------
# both engines against the JAX reference engine
# ---------------------------------------------------------------------------


def toy(n=64, d=16, seed=0):
    rng = np.random.default_rng(seed)
    X, y = make_linear_dataset(rng, n + 64, d, noise=0.05, separation=3.0)
    return X[:n], y[:n], X[n:], y[n:]


BASE = dict(name="toy", dim=16, n_nodes=64, n_test=64, class_ratio=(1, 1),
            lam=1e-3, variant="mu", drop_prob=0.2, delay_max_cycles=3)
RUN = dict(cycles=20, eval_every=10, seed=5)
WIRES = (None, "int8", "int4")
# every fault on every wire; the defense rotates so that each fault and
# each wire meet all three defenses
ENGINE_CASES = [(fault, wire, jf.DEFENSES[(i + j) % 3])
                for i, fault in enumerate(jf.FAULT_MODELS)
                for j, wire in enumerate(WIRES)]


def economy(r):
    return (r.sent_total, r.delivered_total, r.lost_total, r.overflow_total,
            list(r.delivered_per_cycle))


@pytest.mark.parametrize("fault,wire,defense", ENGINE_CASES)
def test_port_engines_match_the_jax_reference_under_faults(fault, wire,
                                                           defense):
    cfg = dict(BASE, wire_dtype=wire, fault_model=fault, byzantine_frac=0.25,
               defense=defense)
    X, y, Xt, yt = toy()
    jref = jax_run(JConfig(**cfg), X, y, Xt, yt, **RUN)
    pcfg = GossipLinearConfig(**cfg)
    for engine in ("reference", "sharded"):
        r = run_simulation(pcfg, X, y, Xt, yt, device="cpu", engine=engine,
                           **RUN)
        assert economy(r) == economy(jref), engine
        assert r.fault_stats == jref.fault_stats, engine
        assert r.cycles == jref.cycles
        diff = max(abs(a - b) for a, b in zip(r.err_fresh + r.err_voted,
                                              jref.err_fresh + jref.err_voted))
        assert diff <= CURVE_TOL, (engine, diff)
    assert jref.fault_stats["corrupted"] > 0
    if defense != "none" and fault != "zero":
        assert jref.fault_stats["gated"] + jref.fault_stats["clipped"] > 0


def test_bad_fault_knobs_raise_the_reference_errors():
    X, y, Xt, yt = toy(n=32)
    kw = dict(cycles=2, eval_every=2, seed=0, device="cpu")
    cases = [(dict(fault_model="nope", byzantine_frac=0.1),
              "unknown fault model"),
             (dict(defense="median"), "unknown defense"),
             (dict(fault_model="zero", byzantine_frac=1.5), "byzantine_frac")]
    for extra, msg in cases:
        cfg = GossipLinearConfig(**dict(BASE, n_nodes=32, **extra))
        for engine in ("reference", "sharded"):
            with pytest.raises(ValueError, match=msg):
                run_simulation(cfg, X, y, Xt, yt, engine=engine, **kw)
        with pytest.raises(ValueError, match=msg):
            jax_run(JConfig(**dict(BASE, n_nodes=32, **extra)), X, y, Xt, yt,
                    cycles=2, eval_every=2, seed=0)
