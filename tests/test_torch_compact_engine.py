"""The compact packings end to end: every packing of the port's sharded
engine against its dense run and against the JAX engines.

On each wire codec (f32, bf16, int8_sr, int4_ef, ternary_ef) and under
each fault mix (sign_flip + norm_clip, random_payload, bitflip,
stale_replay), the forced ``compact`` and ``compact_all`` runs and the
chooser's run equal the forced ``dense`` run bit for bit: curves, economy,
fault counters, the EF norm and the cache at every eval point (the
``serve_hook`` snapshots). Against the JAX package: ``compaction`` equals
the JAX sharded engine's default run field for field, the economy and
the fault counters equal the JAX reference engine's, the curves are
within 0.02 of it and the EF norm within the port's stated 1e-4. The JAX
reference engine is the oracle here, never the JAX ``compact_all`` leg,
which raises for the random draws and moves the EF norm (ROADMAP.md queue
3). d = 12: the screen's sum order does not depend on the row count
there (``tests/test_torch_compact_split.py`` holds 5 <= d <= 8)."""
import numpy as np
import pytest
import torch

from repro.configs.gossip_linear import GossipLinearConfig as JConfig
from repro.configs.gossip_linear import with_failure_scenario as jscenario
from repro.core.simulation import run_simulation as jax_run
from repro_torch.configs.gossip_linear import (GossipLinearConfig,
                                               with_failure_scenario)
from repro_torch.core.simulation import run_simulation
from test_torch_compact_rounds import bitwise, toy

CURVE_TOL = 0.02
EF_RTOL = 1e-4          # tests/test_torch_engine.py's bound, unchanged
N = 96
RUN = dict(cycles=20, eval_every=10, seed=3, k_rounds=4)

CASES = [pytest.param(dict(wire_dtype=w), id=w or "f32")
         for w in (None, "bf16", "int8_sr", "int4_ef", "ternary_ef")] + [
    pytest.param(dict(fault_model=f, wire_dtype=w, defense=dfn,
                      byzantine_frac=0.25), id=f"{f}-{w or 'f32'}-{dfn}")
    for f, w, dfn in (("sign_flip", None, "norm_clip"),
                      ("random_payload", "int8_sr", "cosine_gate"),
                      ("bitflip", "int4_ef", "none"),
                      ("stale_replay", "ternary", "norm_clip"))]


def snapshots(store):
    """A ``serve_hook`` keeping each eval point's cache as numpy."""
    def hook(cycle, snap):
        store.append([np.asarray(torch.as_tensor(a)).copy() for a in
                      (snap.w, snap.t, snap.count, snap.fresh_w,
                       snap.fresh_t)])
    return hook


@pytest.mark.parametrize("extra", CASES)
def test_every_packing_is_the_dense_run_and_matches_jax(extra):
    X, y, Xt, yt = toy(N)
    base = dict(name="prop", dim=12, n_nodes=N, n_test=48,
                class_ratio=(1, 1), lam=1e-3, variant="mu", **extra)
    pcfg = with_failure_scenario(GossipLinearConfig(**base), "extreme")
    jcfg = jscenario(JConfig(**base), "extreme")
    jref = jax_run(jcfg, X, y, Xt, yt, **RUN)
    jsh = jax_run(jcfg, X, y, Xt, yt, engine="sharded", **RUN)
    runs, snaps = {}, {}
    for mode in ("dense", "compact", "compact_all", None):
        snaps[mode] = []
        runs[mode] = run_simulation(pcfg, X, y, Xt, yt, engine="sharded",
                                    device="cpu", compact_mode=mode,
                                    serve_hook=snapshots(snaps[mode]), **RUN)
    dense = runs["dense"]
    for mode, r in runs.items():
        bitwise(r, dense)
        for got, want in zip(snaps[mode], snaps["dense"]):
            for a, b in zip(got, want):
                assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
        if mode is not None:
            assert r.compaction["chunk_modes"][mode] == len(r.cycles)
    auto = runs[None]
    assert auto.compaction == jsh.compaction
    assert (auto.sent_total, auto.delivered_total, auto.lost_total,
            auto.overflow_total, auto.delivered_per_cycle) == (
        jref.sent_total, jref.delivered_total, jref.lost_total,
        jref.overflow_total, jref.delivered_per_cycle)
    assert auto.fault_stats == jref.fault_stats
    assert auto.wire_bytes_total == jref.wire_bytes_total
    diff = max(abs(a - b) for a, b in zip(auto.err_fresh + auto.err_voted,
                                          jref.err_fresh + jref.err_voted))
    assert diff <= CURVE_TOL, diff
    if jref.ef_residual_norm:
        np.testing.assert_allclose(auto.ef_residual_norm,
                                   jref.ef_residual_norm, rtol=EF_RTOL)
    else:
        assert auto.ef_residual_norm == 0.0
    if "fault_model" in extra:
        assert jref.fault_stats["corrupted"] > 0
