"""The port's paper baselines and metrics against the JAX package.

``repro_torch.utils.metrics`` (0-1, voted and weighted-vote errors,
Welford), ``core.learners.init_model``, ``convert.linear_model_from_arrays``
and ``core.ensemble`` (WB1/WB2 weighted bagging, sequential Pegasos)
against ``repro.utils.metrics``, ``repro.core.learners`` and
``repro.core.ensemble`` on seeded inputs, on the CPU (the step is kernel
#6's plain version there).

Tolerances, measured with jax 0.9.0 against the jitted reference (XLA
fuses the step's products into fused multiply-adds; the port keeps the
Pallas kernel's order):

* sample indices and the counters ``t``: equal;
* the final population ``W`` and the chain's ``w``: within
  ``2e-6 * max|w|`` (measured at most 3.6e-7 of the largest weight on the
  cases below);
* the error curves: within 0.02, the JAX suite's bar (measured at most
  1.5e-8; a margin's hinge decided the other way would move one model);
* the metrics: equal (the error rate is ``metrics.mean_of_mask``, XLA's
  float32 mean bit for bit; the scores' signs lie away from zero).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ensemble as jens
from repro.core import learners as jlearn
from repro.data.synthetic import make_linear_dataset
from repro.utils import metrics as jmetrics
from repro_torch import convert
from repro_torch import random as prandom
from repro_torch.core import ensemble as pens
from repro_torch.core import learners as plearn
from repro_torch.kernels import ops
from repro_torch.kernels import pegasos_update as pu
from repro_torch.utils import metrics as pmetrics

W_RTOL = 2e-6          # of max|w|: the module note
CURVE_TOL = 0.02


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs: its runs are thousands of
    small ops, whose thread pool costs far more than it gains when pytest
    workers share the cores (the theory tests took ~20 s alone and 214 s
    beside three other workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(a):
    return torch.as_tensor(np.asarray(a))


def data(n, d, seed=0):
    rng = np.random.default_rng(seed)
    X, y = make_linear_dataset(rng, n + 100, d, noise=0.05, separation=3.0)
    return X[:n], y[:n], X[n:], y[n:]


def assert_w_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=W_RTOL * np.abs(want).max())


# ------------------------------------------------------------- metrics


def scored(m, n, d, seed):
    """A population and a test set whose scores stay away from zero."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(m, d)).astype(np.float32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    return W, X, y


@pytest.mark.parametrize("m,n,d", [(1, 50, 3), (7, 200, 10), (33, 120, 57)])
@pytest.mark.parametrize("bias", [None, 0.25])
def test_zero_one_error_matches(m, n, d, bias):
    W, X, y = scored(m, n, d, m + d)
    for w in (W, W[0]):                 # a population and one model
        got = pmetrics.zero_one_error(t(w), t(X), t(y), bias=bias)
        want = jmetrics.zero_one_error(jnp.asarray(w), jnp.asarray(X),
                                       jnp.asarray(y), bias=bias)
        assert got.shape == tuple(want.shape)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,n,d", [(1, 50, 3), (4, 200, 10), (10, 120, 57),
                                   (64, 300, 12)])
def test_voted_and_weighted_vote_errors_match(m, n, d):
    W, X, y = scored(m, n, d, 100 + m)
    for pf, jf in ((pmetrics.voted_error, jmetrics.voted_error),
                   (pmetrics.weighted_vote_error,
                    jmetrics.weighted_vote_error)):
        got = pf(t(W), t(X), t(y))
        want = jf(jnp.asarray(W), jnp.asarray(X), jnp.asarray(y))
        assert float(got) == float(want), pf.__name__


def test_voted_error_breaks_even_votes_to_plus():
    W = np.array([[1.0, 0.0], [-1.0, 0.0]], np.float32)    # one vote each
    X = np.array([[1.0, 2.0], [-3.0, 1.0]], np.float32)
    y = np.array([1.0, -1.0], np.float32)
    got = float(pmetrics.voted_error(t(W), t(X), t(y)))
    assert got == float(jmetrics.voted_error(jnp.asarray(W), jnp.asarray(X),
                                              jnp.asarray(y))) == 0.5


@pytest.mark.parametrize("values", [[], [3.0], [1.0, 2.0, 4.0, -7.5],
                                    list(np.linspace(-3, 9, 101))])
def test_welford_matches(values):
    a, b = pmetrics.Welford(), jmetrics.Welford()
    for v in values:
        a.add(float(v))
        b.add(float(v))
    assert (a.n, a.mean, a.m2, a.std) == (b.n, b.mean, b.m2, b.std)


# ------------------------------------------------ init_model, convert


@pytest.mark.parametrize("n", [None, 1, 5])
def test_init_model_matches(n):
    got = plearn.init_model(7, n, device="cpu")
    want = jlearn.init_model(7, n)
    for g, w in zip(got, want):
        assert g.dtype == {"float32": torch.float32,
                           "int32": torch.int32}[str(w.dtype)]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_linear_model_from_arrays_round_trip():
    rng = np.random.default_rng(0)
    for w, tt in ((rng.normal(size=(6, 4)), rng.integers(0, 9, 6)),
                  (rng.normal(size=4), np.int32(3))):
        m = convert.linear_model_from_arrays(w, tt, "cpu")
        assert (m.w.dtype, m.t.dtype) == (torch.float32, torch.int32)
        np.testing.assert_array_equal(m.w.numpy(), w.astype(np.float32))
        np.testing.assert_array_equal(m.t.numpy(), tt)
    with pytest.raises(ValueError, match="expected w"):
        convert.linear_model_from_arrays(np.zeros((2, 3)), np.zeros(3),
                                         "cpu")


@pytest.mark.parametrize("lam", [1e-4, 1e-2])
def test_port_step_continues_a_jax_mid_run_population(lam):
    """A JAX bagging population after 7 cycles, moved by
    ``linear_model_from_arrays``, takes the next cycle's step in the port
    as in the JAX package."""
    X, y, _, _ = data(300, 12)
    key = jax.random.key(4)
    W, tt = jlearn.init_model(12, 64)
    steps = []
    for _ in range(8):
        key, sub = jax.random.split(key)
        idx = np.asarray(jax.random.randint(sub, (64,), 0, 300))
        steps.append(idx)
    for idx in steps[:7]:
        m = jens._bagging_update(W, tt, jnp.asarray(X), jnp.asarray(y),
                                 jnp.asarray(idx), lam)
        W, tt = m.w, m.t
    want = jens._bagging_update(W, tt, jnp.asarray(X), jnp.asarray(y),
                                jnp.asarray(steps[7]), lam)
    pm = convert.linear_model_from_arrays(np.asarray(W), np.asarray(tt),
                                          "cpu")
    idx = steps[7]
    w2, t2 = ops.pegasos_update(pm.w, pm.t, t(X[idx]), t(y[idx]), lam=lam)
    np.testing.assert_array_equal(t2.numpy(), np.asarray(want.t))
    assert_w_close(w2.numpy(), want.w)


# ------------------------------------------------------------ baselines


class Recorder:
    """Wraps a function (on its module) and keeps what each call
    returned."""

    def __init__(self, monkeypatch, module, name):
        self.fn = getattr(module, name)
        self.out = []
        monkeypatch.setattr(module, name, self)

    def __call__(self, *a, **kw):
        r = self.fn(*a, **kw)
        self.out.append(r)
        return r


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


BAGGING = {
    "n300-d12-m64": dict(n=300, d=12, n_models=64, cycles=20, lam=1e-4,
                         eval_every=5, seed=0),
    "n300-d12-lam1e-2": dict(n=300, d=12, n_models=64, cycles=20, lam=1e-2,
                             eval_every=5, seed=3),
    "n500-d57-m128": dict(n=500, d=57, n_models=128, cycles=30, lam=1e-3,
                          eval_every=7, seed=1),
    "n200-d10-m300": dict(n=200, d=10, n_models=300, cycles=25, lam=1e-4,
                          eval_every=10, seed=2),
}


@pytest.mark.parametrize("case", sorted(BAGGING))
def test_weighted_bagging_matches_jax(monkeypatch, case):
    """Indices bit for bit, t equal, W within the stated tolerance, WB1,
    WB2 and the single-model error within 0.02, at the same cycles; WB2
    over min(2^c, n_models) models. ``m > n`` (300 models over 200
    examples) draws with repeats."""
    kw = dict(BAGGING[case])
    X, y, Xt, yt = data(kw.pop("n"), kw.pop("d"))
    jidx = Recorder(monkeypatch, jax.random, "randint")
    jstep = Recorder(monkeypatch, jens, "_bagging_update")
    want = jens.run_weighted_bagging(X, y, Xt, yt, **kw)
    pidx = Recorder(monkeypatch, prandom, "randint")
    pstep = Recorder(monkeypatch, ops, "pegasos_update")
    got = pens.run_weighted_bagging(X, y, Xt, yt, device="cpu", **kw)

    assert len(pidx.out) == len(jidx.out) == kw["cycles"]
    for a, b in zip(pidx.out, jidx.out):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(np_(a), np_(b))
    w, tt = pstep.out[-1]
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jstep.out[-1].t))
    assert_w_close(w.numpy(), jstep.out[-1].w)
    assert got.cycles == want.cycles
    for name in ("err_wb1", "err_wb2", "err_single"):
        diff = np.abs(np.subtract(getattr(got, name), getattr(want, name)))
        assert diff.max() <= CURVE_TOL, name
    assert pu.pegasos_update.launches == 0          # the CPU runs no kernel


SEQUENTIAL = {
    "blocks": dict(n=300, d=12, iters=500, eval_every=100, lam=1e-4, seed=0),
    "ragged-block": dict(n=300, d=12, iters=130, eval_every=50, lam=1e-2,
                         seed=5),
    "one-block-d57": dict(n=500, d=57, iters=400, eval_every=400, lam=1e-3,
                          seed=1),
    "d10": dict(n=200, d=10, iters=300, eval_every=60, lam=1e-4, seed=2),
}


@pytest.mark.parametrize("case", sorted(SEQUENTIAL))
def test_sequential_pegasos_matches_jax(monkeypatch, case):
    """One ``randint(sub, (step,), 0, n)`` a block, bit for bit; the final
    model's t equal and w within the stated tolerance; the points at the
    same iterations, errors within 0.02. Every step goes through
    ``kernels.ops.pegasos_update`` at N = 1 on (1, d) views of padded
    rows, each operand contiguous and on a 16-byte boundary, so that on
    the card ``row_route`` sends d <= 57 to the tiled layout."""
    kw = dict(SEQUENTIAL[case])
    n, d = kw.pop("n"), kw.pop("d")
    X, y, Xt, yt = data(n, d)
    jidx = Recorder(monkeypatch, jax.random, "randint")
    jm, jpts = jens.run_sequential_pegasos(X, y, Xt, yt, **kw)
    pidx = Recorder(monkeypatch, prandom, "randint")
    routes = []

    def step(w, tt, x, yy, *, lam):
        ops_in = (w, tt, x, yy)
        assert all(a.is_contiguous() for a in ops_in)
        assert x.shape == (1, d) and yy.shape == (1,)
        routes.append(pu.row_route(
            d, False, all(a.data_ptr() % 16 == 0 for a in ops_in)))
        return pu.pegasos_update(w, tt, x, yy, lam=lam)
    monkeypatch.setattr(ops, "pegasos_update", step)
    pm, ppts = pens.run_sequential_pegasos(X, y, Xt, yt, device="cpu", **kw)

    assert len(pidx.out) == len(jidx.out)
    for a, b in zip(pidx.out, jidx.out):
        np.testing.assert_array_equal(np_(a), np_(b))
    assert routes == ["tiled"] * kw["iters"]
    assert pm.w.shape == (d,) and pm.t.shape == ()
    assert int(pm.t) == int(jm.t) == kw["iters"]
    assert_w_close(pm.w.numpy(), jm.w)
    assert [p[0] for p in ppts] == [p[0] for p in jpts]
    assert max(abs(a[1] - b[1]) for a, b in zip(ppts, jpts)) <= CURVE_TOL


def test_entry_points_need_cuda_unless_told_cpu(monkeypatch):
    from repro_torch.core import theory as ptheory
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y, Xt, yt = data(40, 5)
    calls = (
        lambda **k: pens.run_weighted_bagging(X, y, Xt, yt, n_models=4,
                                              cycles=2, **k),
        lambda **k: pens.run_sequential_pegasos(X, y, Xt, yt, iters=3, **k),
        lambda **k: plearn.init_model(5, 2, **k),
        lambda **k: ptheory.solve_w_star(X, y, 0.1, iters=3, **k),
        lambda **k: ptheory.mu_chain_regret(X, y, 0.1, steps=2, **k),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        call(device="cpu")


def test_bagging_result_fields_match():
    assert ([f.name for f in dataclasses.fields(pens.BaggingResult)]
            == [f.name for f in dataclasses.fields(jens.BaggingResult)])
