"""The fused receive step and the send encode: the port's plain versions
against the JAX Pallas kernels (interpret mode) and against the reference
``apply_receives`` and codecs.

Receive: integer outputs must be equal; floats within ``rtol=1e-5,
atol=1e-6`` (``apply_receives`` rounds the Pegasos step as ``eta*(y*x)``,
the kernel as ``(eta*y)*x``, and the margins are summed in different
orders); the message decode itself is exact. Send: codes, packed bytes,
scales, zero-points and residuals equal bit for bit. The CUDA kernels run
only on the card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold
them to the plain versions there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import simulation as jsim
from repro.core import wire_codec as jwc
from repro.core.cache import ModelCache as JCache
from repro.core.learners import make_update
from repro.kernels.gossip_cycle import fused_receive_apply as jax_fused
from repro.kernels.gossip_cycle import quantize_send as jax_send
from repro_torch import random
from repro_torch.kernels import gossip_cycle as pt

LAM = 1e-3
N = 37


def make_inputs(seed, n, d, c, k):
    """A mid-run state: random models, counters, ring pointers and a
    random valid mask (numpy, so both packages see the same inputs)."""
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


ORDER = ("last_w", "last_t", "cache_w", "cache_t", "ptr", "count", "msg_w",
         "msg_t", "valid", "x", "y")
OUT = ORDER[:6]


def run_plain(inp, variant):
    args = [torch.tensor(inp[k]) for k in ORDER]
    out = pt.fused_receive_apply(*args, variant=variant, lam=LAM)
    assert all(a is b for a, b in zip(out, args[:6]))   # in place
    return {k: v.numpy() for k, v in zip(OUT, out)}


def assert_state_equal(got, want):
    for k in OUT:
        w = np.asarray(want[k])
        if w.dtype == np.int32:
            assert np.array_equal(got[k], w), k
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("d", [10, 57, 130])
@pytest.mark.parametrize("c", [3, 10])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("variant", ["rw", "mu", "um"])
def test_plain_matches_pallas_kernel_and_apply_receives(variant, k, c, d):
    inp = make_inputs(1000 * k + 10 * c + d, N, d, c, k)
    got = run_plain(inp, variant)

    j = {key: jnp.asarray(v) for key, v in inp.items()}
    out = jax_fused(j["last_w"], j["last_t"], j["cache_w"], j["cache_t"],
                    j["ptr"], j["count"], j["msg_w"], j["msg_t"], j["valid"],
                    j["x"], j["y"], variant=variant, lam=LAM, interpret=True)
    assert_state_equal(got, dict(zip(OUT, out[:6])))

    lw, lt, cache, _, _ = jsim.apply_receives(
        j["last_w"], j["last_t"],
        JCache(j["cache_w"], j["cache_t"], j["ptr"], j["count"]),
        j["msg_w"], j["msg_t"], j["valid"] > 0, j["x"], j["y"],
        variant=variant, update=make_update("pegasos", lam=LAM))
    assert_state_equal(got, dict(zip(OUT, (lw, lt, *cache))))


def test_more_rounds_than_slots_overwrite_in_order():
    """K > C with every round valid: round k writes slot (ptr + k) % C, so
    the last C rounds survive and ptr/count advance by K and to C."""
    inp = make_inputs(3, 5, 4, 2, 5)
    inp["valid"][:] = 1
    got = run_plain(inp, "rw")
    assert np.array_equal(got["ptr"], inp["ptr"] + 5)
    assert np.array_equal(got["count"], np.full(5, 2))
    assert np.array_equal(got["last_w"], inp["msg_w"][-1])
    rows = np.arange(5)
    assert np.array_equal(got["cache_t"][rows, (inp["ptr"] + 4) % 2],
                          inp["msg_t"][-1] + 1)


def test_cpu_tensors_run_the_plain_version_without_launching():
    before = pt.fused_receive_apply.launches
    inp = make_inputs(0, N, 10, 10, 4)
    want = run_plain(inp, "mu")
    args = [torch.tensor(inp[k]) for k in ORDER]
    out = pt.fused_receive_apply_plain(*args, variant="mu", lam=LAM)
    assert_state_equal({k: v.numpy() for k, v in zip(OUT, out)}, want)
    assert pt.fused_receive_apply.launches == before == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "variant",
                                 "wire", "defense"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = {k: torch.tensor(v) for k, v in make_inputs(0, 8, 6, 3, 2).items()}
    kw = dict(variant="mu", lam=LAM)
    err = ValueError
    if bad == "dtype":
        args["last_t"] = args["last_t"].long()
        err = TypeError
    elif bad == "shape":
        args["y"] = args["y"][:-1]
    elif bad == "contiguous":
        args["x"] = args["x"].t().contiguous().t()
    elif bad == "variant":
        kw["variant"] = "avg"
    elif bad == "wire":            # a scale alone names no decode mode
        kw["msg_scale"] = torch.ones((2, 8), dtype=torch.float16)
    else:                          # a screen the reference does not have
        kw["defense"] = "median"
    with pytest.raises(err):
        pt.fused_receive_apply(*(args[k] for k in ORDER), **kw)


# ---------------------------------------------------------------------------
# the wire decode modes of the receive step
# ---------------------------------------------------------------------------


def to_torch(a) -> torch.Tensor:
    """A numpy or JAX array as a tensor of its own dtype (bfloat16 by its
    bits: numpy has no bfloat16 of its own)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def wire_messages(inp, wire, seed):
    """Encode ``inp``'s f32 messages with the JAX codec: the (K, N, P)
    payload and its (K, N) f16 scale and zero-point (None where the codec
    does not carry them)."""
    codec = jwc.get_codec(wire)
    key = jax.random.key(seed) if codec.stochastic else None
    return codec.encode(jnp.asarray(inp["msg_w"]), key=key)


@pytest.mark.parametrize("wire,d", [("bf16", 57), ("f16", 57),
                                    ("int8", 57), ("int8_sr", 10),
                                    ("int4", 57), ("int4_ef", 10),
                                    ("ternary", 57), ("ternary_ef", 7)])
@pytest.mark.parametrize("variant", ["rw", "mu", "um"])
def test_plain_decodes_every_wire_mode_like_the_pallas_kernel(variant, wire,
                                                              d):
    c, k = 3, 4
    inp = make_inputs(7 * d + k, N, d, c, k)
    payload, msc, mzp = wire_messages(inp, wire, d)
    args = [torch.tensor(inp[key]) for key in ORDER]
    args[6] = to_torch(payload)
    kw = dict(wire=wire, variant=variant, lam=LAM)
    if msc is not None:
        kw["msg_scale"] = to_torch(msc)
    if mzp is not None:
        kw["msg_zp"] = to_torch(mzp)
    out = pt.fused_receive_apply(*args, **kw)
    got = {key: v.numpy() for key, v in zip(OUT, out)}

    j = {key: jnp.asarray(v) for key, v in inp.items()}
    jout = jax_fused(j["last_w"], j["last_t"], j["cache_w"], j["cache_t"],
                     j["ptr"], j["count"], payload, j["msg_t"], j["valid"],
                     j["x"], j["y"], msg_scale=msc, msg_zp=mzp, wire=wire,
                     variant=variant, lam=LAM, interpret=True)
    assert_state_equal(got, dict(zip(OUT, jout[:6])))

    decoded = jwc.get_codec(wire).decode(payload, msc, mzp, d)
    lw, lt, cache, _, _ = jsim.apply_receives(
        j["last_w"], j["last_t"],
        JCache(j["cache_w"], j["cache_t"], j["ptr"], j["count"]),
        decoded, j["msg_t"], j["valid"] > 0, j["x"], j["y"],
        variant=variant, update=make_update("pegasos", lam=LAM))
    assert_state_equal(got, dict(zip(OUT, (lw, lt, *cache))))
    # lastModel of a node that received is its last message, decoded
    # exactly as the codec decodes it
    recv = inp["valid"].any(0)
    last_round = k - 1 - np.argmax(inp["valid"][::-1] > 0, axis=0)
    want_last = np.asarray(decoded)[last_round, np.arange(N)]
    assert np.array_equal(got["last_w"][recv], want_last[recv])


def test_receive_wire_checks():
    inp = make_inputs(1, 8, 10, 3, 2)
    args = [torch.tensor(inp[key]) for key in ORDER]
    q = torch.zeros((2, 8, 5), dtype=torch.uint8)
    sc = torch.ones((2, 8), dtype=torch.float16)
    cases = [
        (dict(wire="int4"), q, ValueError),                   # no scale
        (dict(wire="int4", msg_scale=sc, msg_zp=sc), q, ValueError),
        (dict(wire="int4", msg_scale=sc), q[..., :4], ValueError),  # P
        (dict(wire="int4", msg_scale=sc.float()), q, TypeError),
        (dict(wire="int8", msg_scale=sc, msg_zp=sc), q, TypeError),
        (dict(wire="f32", msg_scale=sc), args[6], ValueError),
        (dict(wire="bf16"), args[6], TypeError),              # f32 payload
        (dict(wire="int3"), args[6], ValueError),
    ]
    for kw, msg, err in cases:
        a = list(args)
        a[6] = msg
        with pytest.raises(err):
            pt.fused_receive_apply(*a, variant="rw", lam=LAM, **kw)


# ---------------------------------------------------------------------------
# the send encode
# ---------------------------------------------------------------------------


SEND_WIDTHS = [1, 7, 10, 57, 130]


def send_models(seed, n, d):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(n, d)) * 3).astype(np.float32)
    w[0] = 0.0                                   # zero scale
    w[1] = np.round(w[1] * 2) / 2                # codes on .5 ties
    w[2] *= 1e5                                  # saturating scale
    ef = (rng.normal(size=(n, d)) * 0.2).astype(np.float32)
    return w, ef


@pytest.mark.parametrize("d", SEND_WIDTHS)
@pytest.mark.parametrize("name", ["int8", "int8_sr", "int4", "int4_ef",
                                  "ternary", "ternary_ef"])
def test_quantize_send_plain_matches_the_pallas_kernel(name, d):
    """Bitwise against JAX ``quantize_send`` in interpret mode; for int8_sr
    (whose Pallas kernel raises under jax's partitionable threefry) against
    ``quantize_wire`` with the same key."""
    n = 37
    w, ef = send_models(d, n, d)
    codec = jwc.get_codec(name)
    kw_p, ef_p = {}, None
    if codec.ef:
        ef_p = torch.from_numpy(ef)
    if codec.stochastic:
        kw_p["key"] = random.key(d, device="cpu")
        want = jwc.quantize_wire(jnp.asarray(w), name,
                                 key=jax.random.key(d))
    else:
        want = jax_send(jnp.asarray(w), name,
                        ef=jnp.asarray(ef) if codec.ef else None,
                        interpret=True)
    before = dict(pt.quantize_send.launches)
    got = pt.quantize_send(torch.from_numpy(w), name, ef=ef_p, **kw_p)
    assert pt.quantize_send.launches == before        # CPU: no launch
    plain = pt.quantize_send_plain(torch.from_numpy(w), name, ef=ef_p,
                                   **kw_p)
    assert len(got) == len(want) == len(plain)
    for g, p_, wnt in zip(got, plain, want):
        wnt = np.asarray(wnt)
        assert g.numpy().dtype == wnt.dtype
        assert np.array_equal(g.numpy().view(np.uint8),
                              wnt.view(np.uint8))
        assert torch.equal(g, p_)
    if codec.ef:    # the residual is what the codec's round trip leaves
        x = jnp.asarray(w) + jnp.asarray(ef)
        dec = codec.decode(*codec.encode(x), d)
        assert np.array_equal(got[2].numpy(), np.asarray(x - dec))


def test_quantize_send_checks():
    w = torch.zeros((4, 10))
    k = random.key(0, device="cpu")
    cases = [
        (dict(name="f32"), ValueError),                       # float wire
        (dict(name="bf16"), ValueError),
        (dict(name="int8", ef=w), ValueError),                # no EF lane
        (dict(name="int8_sr"), ValueError),                   # no key
        (dict(name="int8_sr", key=k.to(torch.int32)), TypeError),
        (dict(name="int4_ef", ef=w[:, :9].contiguous()), ValueError),
        (dict(name="int4", w=w.double()), TypeError),
        (dict(name="ternary", w=w.t()), ValueError),          # contiguity
        (dict(name="ternary", w=w[0]), ValueError),           # (N, d)
    ]
    for kw, err in cases:
        kw = dict(kw)
        ww = kw.pop("w", w)
        with pytest.raises(err):
            pt.quantize_send(ww, **kw)
    assert pt.send_kernel_name("int8_sr") == "affine8"
    assert pt.send_kernel_name("int4_ef") == "packed_ef"
    assert pt.send_kernel_name("ternary") == "packed"
