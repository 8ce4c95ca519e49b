"""The port's Theorem 1 check (``repro_torch.core.theory``) against
``repro.core.theory``, and the three assertions of ``tests/test_theory.py``
on the port, on the CPU.

Tolerances, measured with jax 0.9.0 (the port sums the full batch's mean
and the dot products in PyTorch's order, XLA in its own):

* ``svm_objective`` and ``f_i`` at the same w: within 1e-6 of the size of
  their terms, 1 + λ/2 ‖w‖² + |⟨w, x⟩| (the hinge's 1 − y⟨w, x⟩ may cancel;
  measured at most 1.2e-7 of the value where it does not);
* ``solve_w_star``: the objective at the port's w* within rtol 9e-5 of the
  objective at the reference's (measured at most 9.5e-6, at d = 57,
  lam = 1e-3), not which iterate won: the last and the averaged iterate
  may tie within an ulp;
* ``mu_chain_regret``: the same steps, ``holds`` equal, the bound within
  rtol 1e-6 (``max ‖x‖`` sums in another order; measured 2.3e-7) and the
  average regret within rtol 7e-7 on the problem of ``tests/test_theory.py``
  (measured 7.4e-8), 3e-3 on the theory driver's spambase-like geometry
  (measured 3.6e-4, from w*'s 9.5e-6) and 1.5e-4 on its
  malicious-urls-like one (measured 1.7e-5).
"""
import numpy as np
import pytest
import torch

from repro.core import theory as jtheory
from repro.data.synthetic import make_linear_dataset
from repro_torch.core import theory as ptheory


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


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    X, y = make_linear_dataset(rng, 150, 12, noise=0.02, separation=3.0)
    return X, y


def t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize("lam", [1e-3, 1e-2, 0.5])
def test_objectives_match(problem, lam):
    X, y = problem
    rng = np.random.default_rng(int(lam * 1000))
    for _ in range(5):
        w = rng.normal(size=X.shape[1]).astype(np.float32)
        reg = lam / 2 * float(w @ w)
        scale = 1.0 + reg + float(np.mean(np.abs(X @ w)))
        assert abs(float(ptheory.svm_objective(t(w), t(X), t(y), lam))
                   - float(jtheory.svm_objective(w, X, y, lam))) \
            <= 1e-6 * scale
        for i in (0, 7, 149):
            scale = 1.0 + reg + abs(float(X[i] @ w))
            assert abs(float(ptheory.f_i(t(w), t(X[i]), t(y[i]), lam))
                       - float(jtheory.f_i(w, X[i], y[i], lam))) \
                <= 1e-6 * scale


GEOMETRIES = {
    # name -> (n, d, lam, noise, average-regret rtol)
    "test_theory": (150, 12, 0.01, 0.02, 7e-7),
    "spambase-like": (1000, 57, 1e-3, 0.05, 3e-3),
    "malicious-urls-like": (2000, 10, 1e-2, 0.05, 1.5e-4),
}


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_solve_w_star_matches(geom):
    n, d, lam, noise, _ = GEOMETRIES[geom]
    X, y = make_linear_dataset(np.random.default_rng(0), n, d, noise=noise,
                               separation=3.0)
    pw = ptheory.solve_w_star(X, y, lam, device="cpu")
    jw = jtheory.solve_w_star(X, y, lam)
    assert pw.shape == (d,) and pw.dtype == torch.float32
    assert rel(jtheory.svm_objective(pw.numpy(), X, y, lam),
               jtheory.svm_objective(jw, X, y, lam)) <= 9e-5


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
@pytest.mark.parametrize("seed", [0, 1])
def test_mu_chain_regret_matches(geom, seed):
    n, d, lam, noise, regret_rtol = GEOMETRIES[geom]
    X, y = make_linear_dataset(np.random.default_rng(0), n, d, noise=noise,
                               separation=3.0)
    steps = 120
    got = ptheory.mu_chain_regret(X, y, lam, steps, seed, device="cpu")
    want = jtheory.mu_chain_regret(X, y, lam, steps, seed)
    assert got.t == want.t == list(range(1, steps + 1))
    assert got.holds == want.holds
    np.testing.assert_allclose(got.bound, want.bound, rtol=1e-6)
    np.testing.assert_allclose(got.avg_regret, want.avg_regret,
                               rtol=regret_rtol)


# the three assertions of tests/test_theory.py, on the port


def test_w_star_is_near_optimal(problem):
    X, y = problem
    lam = 0.01
    w_star = ptheory.solve_w_star(X, y, lam, device="cpu")
    f_star = float(ptheory.svm_objective(w_star, t(X), t(y), lam))
    rng = np.random.default_rng(1)
    for _ in range(20):
        w = w_star + t(0.05 * rng.normal(size=w_star.shape))
        assert float(ptheory.svm_objective(w, t(X), t(y), lam)) \
            >= f_star - 1e-4


def test_theorem1_bound_holds(problem):
    X, y = problem
    tr = ptheory.mu_chain_regret(X, y, lam=0.01, steps=250, seed=0,
                                 device="cpu")
    assert tr.holds, "Theorem 1 bound violated"
    # the bound decays ~ log t / t; the empirical average regret must track it
    assert tr.avg_regret[-1] <= tr.bound[-1]
    assert tr.bound[-1] < tr.bound[9]


def test_average_regret_decreases(problem):
    X, y = problem
    tr = ptheory.mu_chain_regret(X, y, lam=0.01, steps=300, seed=1,
                                 device="cpu")
    assert tr.avg_regret[-1] < tr.avg_regret[19]
