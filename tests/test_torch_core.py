"""The port's protocol core against the JAX package, module by module.

Inputs are made with numpy from a seed and go through both packages;
integer results must be equal, floats within ``atol=1e-6`` (the packages
sum in different orders)."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gossip_linear as jcfg
from repro.core import cache as jcache
from repro.core import learners as jlearn
from repro.core import peer_sampling as jpeers
from repro.core import simulation as jsim
from repro.data import synthetic as jdata
from repro.core.merge import create_model as jcreate_model
from repro.utils.metrics import cosine_similarity as jcosine
from repro_torch import convert, random
from repro_torch.configs import gossip_linear as pcfg
from repro_torch.core import cache as pcache
from repro_torch.core import learners as plearn
from repro_torch.core import peer_sampling as ppeers
from repro_torch.core import simulation as psim
from repro_torch.data import synthetic as pdata
from repro_torch.utils.metrics import cosine_similarity as pcosine

# the module, not the function: repro_torch.core re-exports the
# reference's names, where ``merge`` is the merge function
pmerge = importlib.import_module("repro_torch.core.merge")

ATOL = 1e-6


def t(a):
    return torch.as_tensor(np.asarray(a))


def close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


# ---------------------------------------------------------------- configs


def test_config_fields_and_defaults_equal():
    jf = [(f.name, f.default) for f in dataclasses.fields(
        jcfg.GossipLinearConfig)]
    pf = [(f.name, f.default) for f in dataclasses.fields(
        pcfg.GossipLinearConfig)]
    assert jf == pf


def test_datasets_and_scenarios_equal():
    assert jcfg.DATASETS.keys() == pcfg.DATASETS.keys()
    for name in jcfg.DATASETS:
        assert (dataclasses.asdict(jcfg.DATASETS[name])
                == dataclasses.asdict(pcfg.DATASETS[name]))
    assert jcfg.FAILURE_SCENARIOS == pcfg.FAILURE_SCENARIOS
    for sc in jcfg.FAILURE_SCENARIOS:
        assert (dataclasses.asdict(jcfg.with_failure_scenario(
            jcfg.SPAMBASE, sc)) == dataclasses.asdict(
                pcfg.with_failure_scenario(pcfg.SPAMBASE, sc)))
    with pytest.raises(ValueError):
        pcfg.with_failure_scenario(pcfg.SPAMBASE, "nope")


def test_config_from_dict_round_trips_the_reference_config():
    ref = jcfg.with_failure_scenario(jcfg.MALICIOUS_URLS, "extreme")
    got = convert.config_from_dict(dataclasses.asdict(ref))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    with pytest.raises(ValueError):
        convert.config_from_dict({"bogus": 1})


# ------------------------------------------------------------------- data


@pytest.mark.parametrize("kw", [
    dict(n=300, d=10, noise=0.07, separation=2.5),
    dict(n=200, d=57, sparsity=0.9, class_ratio=(3, 1)),
])
def test_make_linear_dataset_bitwise(kw):
    n, d = kw.pop("n"), kw.pop("d")
    jx, jy = jdata.make_linear_dataset(np.random.default_rng(5), n, d, **kw)
    px, py = pdata.make_linear_dataset(np.random.default_rng(5), n, d, **kw)
    assert np.array_equal(jx, px) and np.array_equal(jy, py)


@pytest.mark.parametrize("name", sorted(jcfg.DATASETS))
def test_paper_dataset_bitwise(name):
    ref = jdata.paper_dataset(name, seed=1)
    got = pdata.paper_dataset(name, seed=1)
    for a, b in zip(ref[:4], got[:4]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("n,cycles,online", [(500, 30, 0.9), (333, 17, 0.3),
                                             (50, 5, 1.0), (40, 0, 0.5)])
def test_churn_trace_bitwise(n, cycles, online):
    ref = jsim.churn_trace(np.random.default_rng(2), n, cycles, online)
    got = psim.churn_trace(np.random.default_rng(2), n, cycles, online)
    assert ref.dtype == got.dtype and np.array_equal(ref, got)


# --------------------------------------------------------------- learners


def _models(seed, n=9, d=6):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, d)).astype(np.float32)
    tt = rng.integers(0, 30, size=n).astype(np.int32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    return w, tt, x, y


@pytest.mark.parametrize("learner", ["pegasos", "adaline", "logistic"])
@pytest.mark.parametrize("seed", [0, 1])
def test_learner_updates_match(learner, seed):
    w, tt, x, y = _models(seed)
    ju = jlearn.make_update(learner, lam=1e-2, eta=0.05)
    pu = plearn.make_update(learner, lam=1e-2, eta=0.05)
    want = ju(jlearn.LinearModel(jnp.asarray(w), jnp.asarray(tt)),
              jnp.asarray(x), jnp.asarray(y))
    got = pu(plearn.LinearModel(t(w), t(tt)), t(x), t(y))
    close(got.w, want.w)
    assert np.array_equal(got.t.numpy(), np.asarray(want.t))
    # a single (d,) model with a scalar label
    want1 = ju(jlearn.LinearModel(jnp.asarray(w[0]), jnp.int32(tt[0])),
               jnp.asarray(x[0]), float(y[0]))
    got1 = pu(plearn.LinearModel(t(w[0]), torch.tensor(tt[0])), t(x[0]),
              float(y[0]))
    close(got1.w, want1.w)
    assert int(got1.t) == int(want1.t)


@pytest.mark.parametrize("variant", ["rw", "mu", "um"])
def test_create_model_matches(variant):
    w, tt, x, y = _models(4)
    w2, t2, _, _ = _models(5)
    ju = jlearn.make_update("pegasos", lam=1e-3)
    pu = plearn.make_update("pegasos", lam=1e-3)
    want = jcreate_model(
        variant, ju, jlearn.LinearModel(jnp.asarray(w), jnp.asarray(tt)),
        jlearn.LinearModel(jnp.asarray(w2), jnp.asarray(t2)),
        jnp.asarray(x), jnp.asarray(y))
    got = pmerge.create_model(
        variant, pu, plearn.LinearModel(t(w), t(tt)),
        plearn.LinearModel(t(w2), t(t2)), t(x), t(y))
    close(got.w, want.w)
    assert np.array_equal(got.t.numpy(), np.asarray(want.t))


def test_merge_semantics():
    m = pmerge.merge(plearn.LinearModel(torch.tensor([1.0, 3.0]),
                                        torch.tensor(2, dtype=torch.int32)),
                     plearn.LinearModel(torch.tensor([3.0, -1.0]),
                                        torch.tensor(7, dtype=torch.int32)))
    assert m.w.tolist() == [2.0, 1.0] and int(m.t) == 7


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("k,d", [(2, 4), (7, 5)])
def test_eq7_averaged_model_gives_mean_score(seed, k, d):
    """Eq. (7)/(6): the averaged model's score is the mean score, whose
    sign is the |<w,x>|-weighted vote."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(k, d)).astype(np.float32)
    x = rng.normal(size=(d,)).astype(np.float32)
    avg = t(W).sum(dim=0) / k
    scores = W @ x
    np.testing.assert_allclose(float(avg @ t(x)), scores.mean(), rtol=1e-4,
                               atol=1e-5)
    weighted = np.mean(np.abs(scores) * np.sign(scores))
    assert np.sign(weighted) == np.sign(scores.mean())


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("y", [-1.0, 1.0])
def test_eq8_adaline_update_commutes_with_averaging(seed, y):
    """Eq. (8): Adaline's linear activation makes update/merge commute."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(6, 4)).astype(np.float32)
    x = t(rng.normal(size=(4,)).astype(np.float32))
    eta = float(rng.uniform(0.01, 0.5))
    zero = torch.tensor(0, dtype=torch.int32)
    upd = [plearn.adaline_update(plearn.LinearModel(t(w), zero), x, y,
                                 eta).w.numpy() for w in W]
    wbar = plearn.LinearModel(t(W.mean(axis=0)), zero)
    np.testing.assert_allclose(np.mean(upd, axis=0),
                               plearn.adaline_update(wbar, x, y, eta).w,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", range(6))
def test_pegasos_um_equals_mu_when_same_hinge_branch(seed):
    rng = np.random.default_rng(seed)
    w1, w2, x = (rng.normal(size=(4,)).astype(np.float32) for _ in range(3))
    y = float(rng.choice([-1.0, 1.0]))
    tt = torch.tensor(int(rng.integers(1, 20)), dtype=torch.int32)
    upd = lambda m, xx, yy: plearn.pegasos_update(m, xx, yy, 0.1)
    m1, m2 = plearn.LinearModel(t(w1), tt), plearn.LinearModel(t(w2), tt)
    mu = pmerge.create_model_mu(upd, m1, m2, t(x), y)
    um = pmerge.create_model_um(upd, m1, m2, t(x), y)
    same = ((y * (w1 @ x) < 1) == (y * (w2 @ x) < 1)
            == (y * (((w1 + w2) / 2) @ x) < 1))
    if same:
        np.testing.assert_allclose(mu.w, um.w, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------ cache


def _cache(seed, n=7, c=4, d=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, c, d)).astype(np.float32),
            rng.integers(0, 50, size=(n, c)).astype(np.int32),
            rng.integers(0, 20, size=n).astype(np.int32),
            rng.integers(1, c + 1, size=n).astype(np.int32))


def _both(arrs):
    return (jcache.ModelCache(*(jnp.asarray(a) for a in arrs)),
            pcache.ModelCache(*(t(a) for a in arrs)))


def test_init_cache_matches():
    j = jcache.init_cache(5, 3, 4)
    p = pcache.init_cache(5, 3, 4, "cpu")
    for a, b in zip(j, p):
        assert np.array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cache_add_and_freshest_match(seed):
    arrs = _cache(seed)
    jc, pc = _both(arrs)
    rng = np.random.default_rng(seed + 10)
    mask = rng.random(7) < 0.6
    w_new = rng.normal(size=(7, 5)).astype(np.float32)
    t_new = rng.integers(0, 9, size=7).astype(np.int32)
    j2 = jcache.cache_add(jc, jnp.asarray(mask), jnp.asarray(w_new),
                          jnp.asarray(t_new))
    p2 = pcache.cache_add(pc, t(mask), t(w_new), t(t_new))
    for a, b in zip(j2, p2):
        assert np.array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jcache.freshest(j2), pcache.freshest(p2)):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(pc.w.numpy(), arrs[0])   # input left unchanged


@pytest.mark.parametrize("seed", [0, 1])
def test_predictions_match(seed):
    arrs = _cache(seed)
    jc, pc = _both(arrs)
    X = np.random.default_rng(seed).normal(size=(11, 5)).astype(np.float32)
    assert np.array_equal(pcache.predict_fresh(pc, t(X)).numpy(),
                          np.asarray(jcache.predict_fresh(jc, jnp.asarray(X))))
    assert np.array_equal(pcache.voted_predict(pc, t(X)).numpy(),
                          np.asarray(jcache.voted_predict(jc, jnp.asarray(X))))


def test_prediction_tie_rules():
    """score == 0 votes +1 (``score >= 0``); an even split predicts +1
    (``p_ratio - 0.5 >= 0``) — in both packages."""
    d = 3
    w = np.zeros((2, 2, d), np.float32)
    w[1, 0] = [1.0, 0.0, 0.0]                  # node 1: slot 0 votes sign(x0)
    w[1, 1] = [-1.0, 0.0, 0.0]                 # slot 1 votes -sign(x0)
    arrs = (w, np.zeros((2, 2), np.int32), np.array([1, 2], np.int32),
            np.array([1, 2], np.int32))
    jc, pc = _both(arrs)
    X = np.array([[0.0, 1.0, 1.0], [2.0, 0.0, 0.0]], np.float32)
    fresh = pcache.predict_fresh(pc, t(X)).numpy()
    voted = pcache.voted_predict(pc, t(X)).numpy()
    assert np.all(fresh[0] == 1.0)             # zero model: score 0 -> +1
    assert np.all(voted[1] == 1.0)             # 1 of 2 votes -> +1
    assert np.array_equal(fresh, np.asarray(jcache.predict_fresh(
        jc, jnp.asarray(X))))
    assert np.array_equal(voted, np.asarray(jcache.voted_predict(
        jc, jnp.asarray(X))))


@pytest.mark.parametrize("m,d", [(2, 3), (17, 10), (40, 57)])
def test_cosine_similarity_matches(m, d):
    W = np.random.default_rng(m).normal(size=(m, d)).astype(np.float32)
    W[0] = 0.0                                  # the zero-norm clamp
    close(pcosine(t(W)), jcosine(jnp.asarray(W)))


# ---------------------------------------------------------- peer sampling


@pytest.mark.parametrize("n", [2, 9, 32, 33, 1000, 1001])
@pytest.mark.parametrize("seed", [0, 5])
def test_peer_samplers_match(seed, n):
    jk = jax.random.key(seed)
    pk = random.key(seed, device="cpu")
    u = ppeers.uniform_peers(pk, n)
    assert u.dtype == torch.int32
    assert np.array_equal(u.numpy(), np.asarray(jpeers.uniform_peers(jk, n)))
    assert not np.any(u.numpy() == np.arange(n))
    m = ppeers.perfect_matching(pk, n)
    assert m.dtype == torch.int32
    assert np.array_equal(m.numpy(),
                          np.asarray(jpeers.perfect_matching(jk, n)))
    assert np.array_equal(m.numpy()[m.numpy()], np.arange(n))   # involution
    assert int((m.numpy() == np.arange(n)).sum()) == n % 2


# ------------------------------------------------------ receiver selection


@pytest.mark.parametrize("k_rounds", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_select_receivers_matches(seed, k_rounds):
    rng = np.random.default_rng(seed)
    D, n, clock = 5, 23, 12
    dst = rng.integers(0, n, size=(D, n)).astype(np.int32)
    arr = np.where(rng.random((D, n)) < 0.7,
                   rng.integers(clock - 1, clock + 2, size=(D, n)),
                   -1).astype(np.int32)
    online = rng.random(n) < 0.8
    want = jsim.select_receivers(jnp.asarray(dst), jnp.asarray(arr),
                                 jnp.asarray(online), clock, k_rounds)
    got = psim.select_receivers(t(dst), t(arr), t(online), clock, k_rounds)
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a).astype(np.int64),
                              b.numpy().astype(np.int64))
