"""The port's engines against the JAX package's, end to end.

(a) ``run_simulation`` of both port engines against the JAX reference
engine and the JAX sharded engine on its Pallas path (interpret mode): the
message economy and ``delivered_per_cycle`` exactly equal, the curves
within 0.02 at every eval point (the JAX suite's own bar; they are
expected equal). (b) One dense chunk from the same carry through both
packages. (c) The port imports neither JAX nor the JAX package. (d) Entry
points run on CUDA unless told otherwise, and the options this slice does
not port raise."""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gossip_linear import GossipLinearConfig as JConfig
from repro.core import sharded_engine as jse
from repro.core.simulation import run_simulation as jax_run
from repro.data.synthetic import make_linear_dataset
from repro_torch import convert
from repro_torch.configs.gossip_linear import GossipLinearConfig
from repro_torch.core import sharded_engine as pse
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
    assert psh.compaction == {"chunk_modes": {"dense": len(psh.cycles)}}


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
    pse.run_dense_chunk(pc, torch.as_tensor(table), torch.as_tensor(X),
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
    carry = list(_jax_carry(np.random.default_rng(0), 4, 3, 2, 2))
    carry[10] = np.zeros((2, 4), np.float16)
    with pytest.raises(NotImplementedError):
        convert.state_from_arrays(carry, "cpu")
    with pytest.raises(ValueError):
        convert.state_from_arrays(carry[:5], "cpu")


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


@pytest.mark.parametrize("opt", [
    dict(cfg=dict(wire_dtype="int8")), dict(cfg=dict(fault_model="zero")),
    dict(cfg=dict(defense="norm_clip")), dict(run=dict(serve_hook=print)),
    dict(run=dict(telemetry=object())),
    dict(run=dict(engine="sharded", mesh=object())),
    dict(run=dict(engine="sharded", compact_mode="compact_all")),
    dict(run=dict(engine="sharded", use_send_kernel=True)),
    dict(cfg=dict(learner="adaline"), run=dict(engine="sharded")),
])
def test_unported_options_raise_naming_the_roadmap(opt):
    cfg = GossipLinearConfig(**small_cfg(n_nodes=32, **opt.get("cfg", {})))
    X, y, Xt, yt = toy(n=32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        run_simulation(cfg, X, y, Xt, yt, cycles=2, device="cpu",
                       **opt.get("run", {}))


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
