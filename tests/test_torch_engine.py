"""The port's engines against the JAX package's, end to end.

(a) ``run_simulation`` of both port engines against the JAX reference
engine and the JAX sharded engine on its Pallas path (interpret mode): the
message economy and ``delivered_per_cycle`` exactly equal, the curves
within 0.02 at every eval point (the JAX suite's own bar; they are
expected equal). (b) One dense chunk from the same carry through both
packages. (c) The port imports neither JAX nor the JAX package. (d) Entry
points run on CUDA unless told otherwise, and the options this slice does
not port raise. (e) Every wire codec on both port engines against the JAX
reference engine and the JAX sharded engine's dense packing without
Pallas (the JAX Pallas send kernel raises for int8_sr, and its compact_all
leg differs in ``ef_residual_norm``: ROADMAP.md queue 3)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gossip_linear import GossipLinearConfig as JConfig
from repro.core import sharded_engine as jse
from repro.core import wire_codec as jwc
from repro.core.simulation import run_simulation as jax_run
from repro.data.synthetic import make_linear_dataset
from repro_torch import convert
from repro_torch.configs.gossip_linear import GossipLinearConfig
from repro_torch import random
from repro_torch.core import sharded_engine as pse
from repro_torch.core import simulation as psim
from repro_torch.core.simulation import run_simulation
from repro_torch.kernels import gossip_cycle

REPO = Path(__file__).resolve().parent.parent
CURVE_TOL = 0.02


def small_cfg(n_nodes=128, **kw):
    base = dict(name="toy", dim=16, n_nodes=n_nodes, n_test=64,
                class_ratio=(1, 1), lam=1e-3, variant="mu")
    base.update(kw)
    return base


def toy(n=128, d=16, seed=0):
    rng = np.random.default_rng(seed)
    X, y = make_linear_dataset(rng, n + 64, d, noise=0.05, separation=3.0)
    return X[:n], y[:n], X[n:], y[n:]


def multirecord():
    rng = np.random.default_rng(0)
    X, y = make_linear_dataset(rng, 64 * 3 + 32, 8, noise=0.05)
    return X[:192].reshape(64, 3, 8), y[:192].reshape(64, 3), X[192:], y[192:]


# The wire-None configs of tests/test_sharded_engine.py.
CASES = {
    "clean": (small_cfg(), toy, dict(cycles=30, eval_every=10, seed=1)),
    "extreme": (small_cfg(drop_prob=0.5, delay_max_cycles=10,
                          online_fraction=0.9), toy,
                dict(cycles=40, eval_every=20, seed=3)),
    **{f"{v}-drop0.2-delay3": (
        small_cfg(n_nodes=64, variant=v, drop_prob=0.2, delay_max_cycles=3),
        lambda: toy(n=64), dict(cycles=20, eval_every=10, seed=5))
       for v in ("mu", "um", "rw")},
    **{f"n{n}-{s}": (small_cfg(n_nodes=n), lambda n=n: toy(n=n),
                     dict(cycles=16, eval_every=8, seed=2, sampler=s))
       for n in (32, 33) for s in ("uniform", "matching")},
    "multirecord": (small_cfg(n_nodes=64, dim=8), multirecord,
                    dict(cycles=12, eval_every=6, seed=4)),
}


def economy(r):
    return (r.sent_total, r.delivered_total, r.lost_total, r.overflow_total,
            list(r.delivered_per_cycle))


def max_curve_diff(a, b):
    assert a.cycles == b.cycles
    return max(abs(x - y) for x, y in zip(a.err_fresh + a.err_voted,
                                           b.err_fresh + b.err_voted))


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_engines_match_both_jax_engines(case):
    cfg, data, kw = CASES[case]
    X, y, Xt, yt = data()
    jref = jax_run(JConfig(**cfg), X, y, Xt, yt, **kw)
    jpal = jax_run(JConfig(**cfg), X, y, Xt, yt, engine="sharded",
                   use_pallas=True, interpret=True, **kw)
    jsh = jax_run(JConfig(**cfg), X, y, Xt, yt, engine="sharded", **kw)
    pcfg = GossipLinearConfig(**cfg)
    pref = run_simulation(pcfg, X, y, Xt, yt, device="cpu", **kw)
    psh = run_simulation(pcfg, X, y, Xt, yt, device="cpu", engine="sharded",
                         **kw)
    assert economy(jref) == economy(jpal)
    for r in (pref, psh):
        assert economy(r) == economy(jref)
        assert r.sent_total == (r.delivered_total + r.lost_total
                                + r.overflow_total + r.in_flight_total)
    assert pref.in_flight_total == psh.in_flight_total
    diffs = {"ref/ref": max_curve_diff(pref, jref),
             "sharded/ref": max_curve_diff(psh, jref),
             "sharded/pallas": max_curve_diff(psh, jpal)}
    print(case, "max curve difference", diffs)
    assert max(diffs.values()) <= CURVE_TOL, diffs
    # the packing choice is the JAX sharded engine's default run's (on the
    # CPU both compact wherever the cost model says so)
    assert psh.compaction == jsh.compaction


def _jax_carry(rng, n, d, C, D):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    i = lambda lo, hi, *s: rng.integers(lo, hi, size=s).astype(np.int32)
    cw, ct = f(n, C, d), i(0, 30, n, C)
    ptr, cnt = i(1, 3 * C, n), i(1, C + 1, n)
    slot = (ptr - 1) % C
    return (f(n, d), i(0, 30, n), cw[np.arange(n), slot],
            ct[np.arange(n), slot], cw, ct, ptr, cnt, f(D, n, d),
            i(0, 30, D, n), np.zeros((0, 0), np.float16),
            np.zeros((0, 0), np.float16), np.zeros((0, 0), np.float32),
            np.int32(7))


@pytest.mark.parametrize("variant", ["rw", "mu", "um"])
def test_one_dense_chunk_matches_the_jax_chunk(variant):
    n, d, C, D, K, T = 40, 12, 5, 4, 3, 3
    rng = np.random.default_rng(11)
    carry = _jax_carry(rng, n, d, C, D)
    # winner rounds fill in order: round r is valid only where r-1 is
    depth = rng.integers(0, K + 1, size=(T, n))
    table = np.where(np.arange(K)[None, :, None] < depth[:, None, :],
                     rng.integers(0, D * n, size=(T, K, n)), -1
                     ).astype(np.int32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)

    fn = jse._build_chunk_fn(variant, "pegasos", 1e-3, 0.01, D, False, False,
                             None, None, "dense", None, False)
    keydata = np.zeros((T, 2), np.uint32)
    eval_idx = jnp.arange(4)
    jout, _ = fn(tuple(jnp.asarray(a) for a in carry), (jnp.asarray(table),),
                 jnp.asarray(keydata), jnp.asarray(X), jnp.asarray(y),
                 jnp.asarray(X[:4]), jnp.asarray(y[:4]), eval_idx, None)
    want = [np.asarray(a) for a in jout]

    pc = convert.state_from_arrays(carry, "cpu")
    pse.run_chunk(pc, "dense", (torch.as_tensor(table),), torch.as_tensor(X),
                  torch.as_tensor(y), variant=variant, lam=1e-3)
    got = convert.to_arrays(pc)
    assert int(got[-1]) == int(want[-1]) == 7 + T
    for name, a, b in zip(convert.CARRY_FIELDS, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype == np.int32:
            assert np.array_equal(a, b), name
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4,
                                       err_msg=name)


def test_state_from_arrays_rejects_quantized_lanes():
    """The quantized lanes (payload in its own dtype, f16 scale and
    zero-point, f32 EF residual) round-trip bit for bit; a carry of the
    wrong length or a payload of no codec's dtype is refused."""
    rng = np.random.default_rng(0)
    carry = list(_jax_carry(rng, 4, 3, 2, 2))
    carry[8] = rng.integers(-127, 128, size=(2, 4, 3)).astype(np.int8)
    carry[10] = rng.normal(size=(2, 4)).astype(np.float16)
    carry[11] = rng.normal(size=(2, 4)).astype(np.float16)
    carry[12] = rng.normal(size=(4, 3)).astype(np.float32)
    pc = convert.state_from_arrays(carry, "cpu")
    assert (pc.buf_w.dtype, pc.buf_scale.dtype, pc.ef.dtype) == (
        torch.int8, torch.float16, torch.float32)
    for name, a, b in zip(convert.CARRY_FIELDS, convert.to_arrays(pc),
                          carry):
        assert a.dtype == np.asarray(b).dtype, name
        assert np.array_equal(a, b), name
    packed = list(carry)
    packed[8] = rng.integers(0, 243, size=(2, 4, 1)).astype(np.uint8)
    assert convert.to_arrays(convert.state_from_arrays(packed, "cpu"))[8] \
        .tobytes() == packed[8].tobytes()
    bf16 = list(carry)
    bf16[8] = np.asarray(jnp.asarray(carry[0][None].repeat(2, 0),
                                     jnp.bfloat16))
    got = convert.to_arrays(convert.state_from_arrays(bf16, "cpu"))[8]
    assert got.tobytes() == bf16[8].tobytes()
    with pytest.raises(ValueError):
        convert.state_from_arrays(carry[:5], "cpu")
    carry[8] = carry[8].astype(np.int16)
    with pytest.raises(ValueError, match="payload"):
        convert.state_from_arrays(carry, "cpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(REPO / "src" / "repro_torch")
                                  .with_suffix("").parts)
        for p in (REPO / "src" / "repro_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
            "assert not bad, bad\nprint(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 14


def test_port_sources_reference_no_jax_package():
    pat = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)", re.M)
    files = list((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for p in files:
        hits = pat.findall(p.read_text())
        assert not hits, (p, hits)


def test_entry_points_need_cuda_unless_told_cpu(monkeypatch):
    from repro_torch import random

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GossipLinearConfig(**small_cfg(n_nodes=32))
    X, y, Xt, yt = toy(n=32)
    for engine in ("reference", "sharded"):
        with pytest.raises(RuntimeError, match="CUDA"):
            run_simulation(cfg, X, y, Xt, yt, cycles=2, engine=engine)
        r = run_simulation(cfg, X, y, Xt, yt, cycles=2, engine=engine,
                           device="cpu")
        assert r.cycles == [2]
    with pytest.raises(RuntimeError, match="CUDA"):
        random.key(0)
    with pytest.raises(ValueError, match="use_kernel"):
        run_simulation(cfg, X, y, Xt, yt, cycles=2, engine="sharded",
                       device="cpu", use_kernel=True)


class _TwoRankMesh:
    """What the engine reads of a mesh before it asks for a process
    group: a ``nodes`` axis of two ranks."""
    mesh_dim_names = ("nodes",)
    mesh = torch.arange(2)


@pytest.mark.parametrize("n,kw,err,match", [
    (33, {}, ValueError,
     r"needs N divisible by the 'nodes' mesh axis \(33 % 2 != 0\)"),
    (33, dict(serve_hook=lambda c, s: None), ValueError,
     r"needs N divisible by the 'nodes' mesh axis \(33 % 2 != 0\)"),
    (33, dict(telemetry="armed"), ValueError,
     r"needs N divisible by the 'nodes' mesh axis \(33 % 2 != 0\)"),
], ids=["indivisible", "serve_hook", "telemetry"])
def test_node_mesh_errors(n, kw, err, match):
    """N not divisible by the node axis raises before any collective,
    with the serving and telemetry hooks too (which run under a node
    mesh: ``test_torch_mesh_serving.py``)."""
    cfg = GossipLinearConfig(**small_cfg(n_nodes=n))
    X, y, Xt, yt = toy(n=n)
    with pytest.raises(err, match=match):
        run_simulation(cfg, X, y, Xt, yt, cycles=2, device="cpu",
                       engine="sharded", mesh=_TwoRankMesh, **kw)


def test_reference_engine_runs_every_learner():
    X, y, Xt, yt = toy(n=32)
    for learner in ("adaline", "logistic"):
        base = small_cfg(n_nodes=32, learner=learner)
        kw = dict(cycles=6, eval_every=3, seed=1)
        j = jax_run(JConfig(**base), X, y, Xt, yt, **kw)
        p = run_simulation(GossipLinearConfig(**base), X, y, Xt, yt,
                           device="cpu", **kw)
        assert economy(p) == economy(j)
        assert max_curve_diff(p, j) <= CURVE_TOL


def test_kernel_launch_count_stays_zero_on_cpu():
    cfg = GossipLinearConfig(**small_cfg(n_nodes=32))
    X, y, Xt, yt = toy(n=32)
    before = gossip_cycle.fused_receive_apply.launches
    run_simulation(cfg, X, y, Xt, yt, cycles=4, engine="sharded",
                   device="cpu")
    assert gossip_cycle.fused_receive_apply.launches == before


# ---------------------------------------------------------------------------
# the wire codecs
# ---------------------------------------------------------------------------


WIRE_CFG = small_cfg(n_nodes=64, drop_prob=0.2, delay_max_cycles=3)
WIRE_KW = dict(cycles=20, eval_every=10, seed=5)
# measured on this config (port reference vs JAX reference): int4_ef
# 8.2e-6 relative, ternary_ef 1.1e-7; both engines of the port agree with
# each other bit for bit
EF_RTOL = 1e-4


@pytest.mark.parametrize("wire", sorted(jwc.WIRE_CODECS))
def test_port_engines_match_jax_engines_on_every_codec(wire):
    cfg = dict(WIRE_CFG, wire_dtype=wire)
    X, y, Xt, yt = toy(n=64)
    jref = jax_run(JConfig(**cfg), X, y, Xt, yt, **WIRE_KW)
    jdense = jax_run(JConfig(**cfg), X, y, Xt, yt, engine="sharded",
                     compact_mode="dense", use_pallas=False, **WIRE_KW)
    pcfg = GossipLinearConfig(**cfg)
    pref = run_simulation(pcfg, X, y, Xt, yt, device="cpu", **WIRE_KW)
    psh = run_simulation(pcfg, X, y, Xt, yt, device="cpu", engine="sharded",
                         **WIRE_KW)
    for r in (jdense, pref, psh):
        assert economy(r) == economy(jref)
        assert r.wire_bytes_total == jref.wire_bytes_total
        assert r.buf_payload_bytes == jref.buf_payload_bytes
    assert pref.wire_bytes_total == pref.sent_total * \
        psim.message_wire_bytes(16, wire)
    diffs = {"ref/ref": max_curve_diff(pref, jref),
             "sharded/ref": max_curve_diff(psh, jref),
             "sharded/dense": max_curve_diff(psh, jdense)}
    print(wire, "max curve difference", diffs)
    assert max(diffs.values()) <= CURVE_TOL, diffs
    codec = jwc.get_codec(wire)
    for r in (pref, psh):
        if codec.ef:
            assert r.ef_residual_norm > 0.0
            np.testing.assert_allclose(r.ef_residual_norm,
                                       jref.ef_residual_norm, rtol=EF_RTOL)
        else:
            assert r.ef_residual_norm == jref.ef_residual_norm == 0.0
    assert psh.ef_residual_norm == pref.ef_residual_norm


@pytest.mark.parametrize("wire", ["int4_ef", "ternary_ef"])
def test_ef_residual_updates_only_on_sends(wire):
    """A node that does not transmit keeps its residual: one reference
    cycle from a state with a known residual changes exactly the senders'
    rows, and under churn and drop (many non-senders a cycle) the sharded
    engine, which refreshes the residual through the device send mask,
    lands on the reference engine's residual."""
    n, d = 48, 8
    rng = np.random.default_rng(2)
    state = psim.init_state(n, d, 4, 3, "cpu", wire_dtype=wire)
    ef0 = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    cache = state.cache._replace(
        w=torch.from_numpy(rng.normal(size=(n, 4, d)).astype(np.float32)))
    state = state._replace(ef=ef0.clone(), cache=cache)
    online = torch.from_numpy(rng.random(n) < 0.5)
    X = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    y = torch.ones(n)
    new, stats = psim.simulate_cycle(
        state, X, y, online, random.key(4, device="cpu"), variant="mu",
        learner="pegasos", lam=1e-3, eta=0.01, drop=0.5, delay_max=3,
        k_rounds=2, sampler="uniform", wire_dtype=wire)
    sent = new.buf_arrival[0] >= 0
    assert 0 < int(sent.sum()) == int(stats["sent"]) < n
    assert torch.equal(new.ef[~sent], ef0[~sent])
    assert not torch.equal(new.ef[sent], ef0[sent])

    X, y, Xt, yt = toy(n=96)
    cfg = GossipLinearConfig(**small_cfg(
        n_nodes=96, drop_prob=0.6, delay_max_cycles=5, online_fraction=0.5,
        wire_dtype=wire))
    kw = dict(cycles=25, eval_every=25, seed=11, device="cpu")
    ref = run_simulation(cfg, X, y, Xt, yt, **kw)
    sh = run_simulation(cfg, X, y, Xt, yt, engine="sharded", **kw)
    assert ref.err_fresh == sh.err_fresh
    assert ref.ef_residual_norm == sh.ef_residual_norm > 0.0


@pytest.mark.parametrize("wire", ["bf16", "int8_sr", "int4_ef", "ternary"])
def test_one_dense_chunk_on_the_wire_matches_the_jax_chunk(wire):
    """The dense chunk with the codec's gather, decode, send encode and EF
    refresh, from one carry through both packages (JAX without Pallas)."""
    n, d, C, D, K, T = 40, 12, 5, 5, 3, 3
    codec = jwc.get_codec(wire)
    rng = np.random.default_rng(13)
    carry = list(_jax_carry(rng, n, d, C, D))
    payload, sc, zp = codec.encode(jnp.asarray(carry[8]),
                                   key=jax.random.key(1))
    carry[8] = np.asarray(payload)
    if sc is not None:
        carry[10] = np.asarray(sc)
    if zp is not None:
        carry[11] = np.asarray(zp)
    if codec.ef:
        carry[12] = (rng.normal(size=(n, d)) * 0.1).astype(np.float32)
    depth = rng.integers(0, K + 1, size=(T, n))
    # messages come from the rows this chunk does not write (0 and 1; the
    # chunk writes rows 7 % D .. 9 % D), so both packages receive the same
    # bytes
    table = np.where(np.arange(K)[None, :, None] < depth[:, None, :],
                     rng.integers(0, 2 * n, size=(T, K, n)), -1
                     ).astype(np.int32)
    mask = rng.random((T, n)) < 0.6
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    keys = random.split(random.key(21, device="cpu"), T)

    fn = jse._build_chunk_fn("mu", "pegasos", 1e-3, 0.01, D, False, False,
                             None, None, "dense", wire, False)
    tables = (jnp.asarray(table),) + ((jnp.asarray(mask),) if codec.ef
                                      else ())
    keydata = jnp.asarray(keys.numpy().astype(np.uint32))
    jout, _ = fn(tuple(jnp.asarray(a) for a in carry), tables, keydata,
                 jnp.asarray(X), jnp.asarray(y), jnp.asarray(X[:4]),
                 jnp.asarray(y[:4]), jnp.arange(4), None)
    want = [np.asarray(a) for a in jout]

    pc = convert.state_from_arrays(carry, "cpu")
    pse.run_chunk(pc, "dense", (torch.as_tensor(table),), torch.as_tensor(X),
                  torch.as_tensor(y), variant="mu", lam=1e-3, wire=wire,
                  keys=keys,
                  send_mask=torch.from_numpy(mask) if codec.ef else None)
    got = dict(zip(convert.CARRY_FIELDS, convert.to_arrays(pc)))
    want = dict(zip(convert.CARRY_FIELDS, want))
    if wire == "bf16":
        want["buf_w"] = want["buf_w"].view(np.uint16)
    # the f32 state agrees within 1e-4, not bit for bit (the two apply
    # paths sum in other orders), so a code written this chunk may land one
    # step away and an f16 scale one ulp away; rows not written this chunk
    # and every integer lane are equal
    rows = [(7 + t) % D for t in range(T)]
    old = [r for r in range(D) if r not in rows]
    for name in convert.CARRY_FIELDS:
        a, b = got[name], want[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name in ("buf_w", "buf_scale", "buf_zp") and a.size:
            assert np.array_equal(a[old], b[old]), name
        elif a.dtype.kind in "iu":
            assert np.array_equal(a, b), name
        elif name != "ef":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4,
                                       err_msg=name)
    step = np.ones((D, n), np.float32)
    if codec.quantized:
        step = np.maximum(got["buf_scale"], want["buf_scale"]).astype(
            np.float32)
        for lane in ("buf_scale", "buf_zp"):
            if got[lane].size:
                np.testing.assert_allclose(
                    got[lane].astype(np.float32),
                    want[lane].astype(np.float32), rtol=2e-3, atol=1e-4,
                    err_msg=lane)
    dec = lambda c: np.asarray(codec.decode(
        jnp.asarray(c["buf_w"].view(np.int16)).view(jnp.bfloat16)
        if wire == "bf16" else jnp.asarray(c["buf_w"]),
        jnp.asarray(c["buf_scale"]) if codec.has_scale else None,
        jnp.asarray(c["buf_zp"]) if codec.has_zp else None, d))
    bound = (1.5 * step if codec.quantized else
             np.abs(dec(want)).max(-1) * 2 ** -7)[..., None] + 1e-4
    assert (np.abs(dec(got) - dec(want)) <= bound).all()
    if codec.ef:
        ef_step = step[rows].max(0)[:, None]
        assert (np.abs(got["ef"] - want["ef"]) <= 2 * ef_step + 1e-4).all()


def test_recv_keys_are_slot_zero_of_the_cycle_split():
    keys = pse.key_schedule(3, 5, "cpu")
    want = torch.stack([random.split(k, 4)[0] for k in keys])
    assert torch.equal(pse.recv_keys(keys), want)


def test_use_send_kernel_follows_the_device_and_the_codec():
    X, y, Xt, yt = toy(n=32)
    kw = dict(cycles=2, engine="sharded", device="cpu")
    q = GossipLinearConfig(**small_cfg(n_nodes=32, wire_dtype="int4"))
    f = GossipLinearConfig(**small_cfg(n_nodes=32, wire_dtype="bf16"))
    with pytest.raises(ValueError, match="use_send_kernel=True on cpu"):
        run_simulation(q, X, y, Xt, yt, use_send_kernel=True, **kw)
    with pytest.raises(ValueError, match="quantized"):
        run_simulation(f, X, y, Xt, yt, use_send_kernel=True, **kw)
    before = dict(gossip_cycle.quantize_send.launches)
    r = run_simulation(q, X, y, Xt, yt, use_send_kernel=False, **kw)
    assert r.cycles == [2]
    assert gossip_cycle.quantize_send.launches == before
