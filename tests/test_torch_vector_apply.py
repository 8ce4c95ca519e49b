"""The vector apply: the port's ``_vector_apply`` against the JAX
package's under ``jax.jit``, as the reference's sharded engine runs it.

The two learners the engine runs it for (Adaline and logistic regression;
Pegasos goes to the receive kernel) × three CREATEMODEL variants × the
three defenses, with K = 5 rounds over a cache of C = 3 (K > C: later
rounds win the ring's collisions), and the port's step in the jitted
order (``learners.make_update(..., fused=True)``;
``tools/measure_step_fusion.py`` measures it). Every integer output
(counters, ring pointers, screen counts) and lastModel (the screened,
possibly rescaled message) are equal bit for bit everywhere. The cached
and freshest weights are equal bit for bit where XLA's fusion follows a
rule (``bitwise``: the step alone, under ``rw``), and elsewhere, where XLA
fuses a product of the merge or of norm_clip's rescale into the step's add
depending on the fusion's shape, within the largest difference measured on
these inputs (``FLOAT_TOL``; ROADMAP.md queue 3)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sharded_engine as jse
from repro.core.cache import ModelCache as JCache
from repro.core.learners import make_update as jax_make_update
from repro_torch.core import sharded_engine as pse
from repro_torch.core.cache import ModelCache
from repro_torch.core.learners import make_update

LAM, ETA, K, C = 1e-3, 0.01, 5, 3
LEARNERS = ("adaline", "logistic")
VARIANTS = ("rw", "mu", "um")
DEFENSES = ("none", "norm_clip", "cosine_gate")
# the largest absolute difference of a cached or freshest weight measured
# on these inputs where the results are not bitwise (tools/
# measure_step_fusion.py shows the same spread on its inputs)
FLOAT_TOL = {"adaline": 4.77e-7, "logistic": 4.77e-7}


def bitwise(learner, variant, defense):
    """Where the port takes XLA's rule and equals the jitted reference."""
    return variant == "rw" and defense != "norm_clip"


def inputs(n, d, defense, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    i = lambda lo, hi, *s: rng.integers(lo, hi, size=s).astype(np.int32)
    return dict(last_w=f(n, d) * 0.3, last_t=i(1, 40, n), fresh_w=f(n, d),
                fresh_t=i(1, 40, n), cw=f(n, C, d), ct=i(0, 40, n, C),
                ptr=i(1, 3 * C, n), cnt=i(1, C + 1, n),
                msg_w=f(K, n, d) * (3.0 if defense == "norm_clip" else 1.0),
                msg_t=i(1, 40, K, n), valid=rng.random((K, n)) < 0.8,
                x=f(n, d),
                y=np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32))


def both(a, learner, variant, defense):
    """The jitted JAX vector apply and the port's on the same inputs, as
    lists of numpy arrays: lastModel, its t, fresh w and t, the cache's
    four lanes, gated, clipped."""
    J = {k: jnp.asarray(v) for k, v in a.items()}
    jfn = jax.jit(functools.partial(
        jse._vector_apply, variant=variant, defense=defense,
        update=jax_make_update(learner, lam=LAM, eta=ETA)))
    jo = jfn(J["last_w"], J["last_t"], J["fresh_w"], J["fresh_t"],
             JCache(J["cw"], J["ct"], J["ptr"], J["cnt"]), J["msg_w"],
             J["msg_t"], J["valid"], J["x"], J["y"])
    T = {k: torch.from_numpy(v) for k, v in a.items()}
    po = pse._vector_apply(
        T["last_w"], T["last_t"], T["fresh_w"], T["fresh_t"],
        ModelCache(T["cw"], T["ct"], T["ptr"], T["cnt"]), T["msg_w"],
        T["msg_t"], T["valid"], T["x"], T["y"], variant=variant,
        defense=defense, update=make_update(learner, lam=LAM, eta=ETA,
                                            fused=True))
    flat = lambda o: [o[0], o[1], o[2], o[3], *o[4], o[5], o[6]]
    return ([np.asarray(v) for v in flat(jo)],
            [v.numpy() for v in flat(po)])


CASES = [(ln, v, dfn, 10) for ln in LEARNERS for v in VARIANTS
         for dfn in DEFENSES] + [
    (ln, "mu", dfn, d) for ln in LEARNERS for d in (6, 57)
    for dfn in ("none", "norm_clip")]


@pytest.mark.parametrize("learner,variant,defense,d", CASES)
def test_vector_apply_equals_the_jitted_reference(learner, variant, defense,
                                                  d):
    want, got = both(inputs(300, d, defense), learner, variant, defense)
    names = ("last_w", "last_t", "fresh_w", "fresh_t", "cache_w", "cache_t",
             "ptr", "count", "gated", "clipped")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name in ("fresh_w", "cache_w"):
            if bitwise(learner, variant, defense):
                assert np.array_equal(a.view(np.int32), b.view(np.int32)), \
                    name
            else:
                np.testing.assert_allclose(a, b, rtol=0,
                                           atol=FLOAT_TOL[learner],
                                           err_msg=name)
        elif a.dtype == np.float32:
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), name
        else:
            assert np.array_equal(a, b), name
    if defense == "norm_clip":
        assert got[-1].sum() > 0
    if defense == "cosine_gate":
        assert got[-2].sum() > 0


def test_xla_sigmoid_equals_jit_bitwise():
    """The logistic step's sigmoid: XLA's Cephes exp, fused as its IR
    fuses, with subnormal results flushed, over the float range (the
    clamps of exp's input at +-88.38 and of its exponent at +-127
    included)."""
    from repro_torch.core.learners import xla_sigmoid

    rng = np.random.default_rng(0)
    v = np.concatenate([rng.normal(size=200_000) * 4,
                        rng.uniform(-100, 100, 50_000),
                        [0.0, -0.0, 88.0, -88.0, 89.0, -104.0, 1e-30]]
                       ).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.sigmoid)(v))
    got = xla_sigmoid(torch.from_numpy(v)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
