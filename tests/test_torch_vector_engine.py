"""Adaline and logistic regression on the port's sharded engine (the
vector apply, dense and compact) against both JAX engines: the economy
exact, ``compaction`` field for field the JAX sharded engine's, the
curves within 0.02 of the JAX reference engine and of the JAX sharded
engine, and every packing of the port bit for bit its dense run."""
import numpy as np
import pytest

from repro.configs.gossip_linear import GossipLinearConfig as JConfig
from repro.configs.gossip_linear import with_failure_scenario as jscenario
from repro.core.simulation import run_simulation as jax_run
from repro_torch.configs.gossip_linear import (GossipLinearConfig,
                                               with_failure_scenario)
from repro_torch.core.simulation import run_simulation
from test_torch_compact_rounds import bitwise, toy

CURVE_TOL = 0.02


def economy(r):
    return (r.sent_total, r.delivered_total, r.lost_total, r.overflow_total,
            list(r.delivered_per_cycle))


@pytest.mark.parametrize("scenario,n,extra", [
    ("clean", 64, {}),
    ("extreme", 96, dict(wire_dtype="int4_ef")),
    ("sparse-d0.8-o0.1", 128, dict(variant="um")),
])
@pytest.mark.parametrize("learner", ["adaline", "logistic"])
def test_vector_learners_match_both_jax_engines(learner, scenario, n, extra):
    X, y, Xt, yt = toy(n)
    base = dict(dict(name="vec", dim=12, n_nodes=n, n_test=48,
                     class_ratio=(1, 1), lam=1e-3, variant="mu",
                     learner=learner), **extra)
    pcfg = with_failure_scenario(GossipLinearConfig(**base), scenario)
    jcfg = jscenario(JConfig(**base), scenario)
    kw = dict(cycles=20, eval_every=10, seed=4)
    jref = jax_run(jcfg, X, y, Xt, yt, **kw)
    jsh = jax_run(jcfg, X, y, Xt, yt, engine="sharded", **kw)
    auto = run_simulation(pcfg, X, y, Xt, yt, engine="sharded", device="cpu",
                          **kw)
    dense = run_simulation(pcfg, X, y, Xt, yt, engine="sharded",
                           device="cpu", compact_mode="dense", **kw)
    bitwise(auto, dense)
    assert auto.compaction == jsh.compaction
    for j in (jref, jsh):
        assert economy(auto) == economy(j)
        diff = max(abs(a - b) for a, b in zip(auto.err_fresh + auto.err_voted,
                                              j.err_fresh + j.err_voted))
        assert diff <= CURVE_TOL, diff
    if "wire_dtype" in extra:
        np.testing.assert_allclose(auto.ef_residual_norm,
                                   jref.ef_residual_norm, rtol=1e-4)
