"""Telemetry's EF residual stream: the port against the JAX package.

``ef_residual_rms`` on the error-feedback codecs is held within rtol 1e-4,
the tolerance ``tests/test_torch_engine.py`` holds ``ef_residual_norm``
to: against the jitted JAX reference engine at every eval point on that
test's wire configuration, and on ``tests/test_torch_telemetry.py``'s
configuration (n = 256, d = 8, 25 cycles, K = 2) against the JAX
reference engine run without ``jit``, whose products are rounded apart
as the port's are. Under ``jit`` XLA fuses the Pegasos step
(ROADMAP.md queue 3), and int4_ef's rounding carries that float gap into
the residual, so on that configuration the jitted engine's stream is
not the oracle. The stream's last value is the run's
``ef_residual_norm``, and it is zero without EF state."""
import jax
import numpy as np
import pytest

from repro.configs.gossip_linear import GossipLinearConfig as JConfig
from repro.core import telemetry as jtel
from repro.core.simulation import run_simulation as jax_run
from repro.data.synthetic import make_linear_dataset
from repro_torch.configs.gossip_linear import GossipLinearConfig
from repro_torch.core.simulation import run_simulation
from repro_torch.core.telemetry import Telemetry

ENGINES = ("reference", "sharded")
EF_RTOL = 1e-4
# tests/test_torch_engine.py's wire configuration
WIRE_CFG = dict(name="toy", dim=16, n_nodes=64, n_test=64,
                class_ratio=(1, 1), lam=1e-3, variant="mu", drop_prob=0.2,
                delay_max_cycles=3)
WIRE_KW = dict(cycles=20, eval_every=10, seed=5)
# tests/test_torch_telemetry.py's configuration
TEL_CFG = dict(name="telemetry-toy", dim=8, n_nodes=256, n_test=64,
               class_ratio=(1, 1), lam=1e-3, variant="mu", cache_size=4)
TEL_KW = dict(cycles=25, eval_every=10, seed=0, k_rounds=2)


def toy(n, d, seed=0):
    rng = np.random.default_rng(seed)
    X, y = make_linear_dataset(rng, n + 64, d, noise=0.05, separation=3.0)
    return X[:n], y[:n], X[n:], y[n:]


@pytest.mark.parametrize("wire", ["int4_ef", "ternary_ef", None])
def test_ef_residual_stream_matches_the_jax_reference(wire):
    """On the engine test's wire configuration: both port engines' EF
    stream within EF_RTOL of the jitted JAX reference engine's at every
    eval point, equal to each other, its last value the run's
    ``ef_residual_norm``; zero without EF state."""
    X, y, Xt, yt = toy(64, 16)
    jt = jtel.Telemetry()
    jax_run(JConfig(**WIRE_CFG, wire_dtype=wire), X, y, Xt, yt,
            telemetry=jt, **WIRE_KW)
    want = jt.stream_array("ef_residual_rms")
    got = {}
    for engine in ENGINES:
        tel = Telemetry()
        res = run_simulation(GossipLinearConfig(**WIRE_CFG, wire_dtype=wire),
                             X, y, Xt, yt, engine=engine, telemetry=tel,
                             device="cpu", **WIRE_KW)
        got[engine] = tel.stream_array("ef_residual_rms")
        assert got[engine].size == want.size == 2
        assert got[engine][-1] == res.ef_residual_norm
    assert np.array_equal(got["reference"], got["sharded"])
    if wire is None:
        assert not want.any() and not got["sharded"].any()
    else:
        assert (want > 0).all()
        np.testing.assert_allclose(got["sharded"], want, rtol=EF_RTOL)


def test_ef_residual_stream_follows_the_unjitted_reference():
    """int4_ef on the telemetry configuration: the port's EF stream within
    EF_RTOL of the JAX reference engine's run without ``jit`` (products
    rounded apart, as in the port), at every eval point."""
    X, y, Xt, yt = toy(256, 8)
    jt = jtel.Telemetry()
    with jax.disable_jit():
        jax_run(JConfig(**TEL_CFG, wire_dtype="int4_ef"), X, y, Xt, yt,
                telemetry=jt, **TEL_KW)
    tel = Telemetry()
    run_simulation(GossipLinearConfig(**TEL_CFG, wire_dtype="int4_ef"), X,
                   y, Xt, yt, engine="sharded", telemetry=tel, device="cpu",
                   **TEL_KW)
    want = jt.stream_array("ef_residual_rms")
    assert want.size == 3 and (want > 0).all()
    np.testing.assert_allclose(tel.stream_array("ef_residual_rms"), want,
                               rtol=EF_RTOL)
