"""The engine's receive step under the screens: the port against the
jitted reference.

``apply_receives`` of the port against the reference's under
``jax.jit``, as its engine runs it (mu): lastModel (the screened, possibly
rescaled message) and the gated and clipped counts bit for bit, at the
paper's widths d = 10 and 57 and at d = 6 and 8, where XLA sums some of
the screen's rows unfused (``faults.screen_split``). Its cases are large
(N = 20 000), so it runs on a worker of its own, apart from
``tests/test_torch_faults.py``."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.cache import ModelCache as JCache
from repro.core.learners import make_update as jax_make_update
from repro.core.simulation import apply_receives as jax_apply_receives
from repro_torch.core.cache import ModelCache
from repro_torch.core.learners import make_update as port_make_update
from repro_torch.core.simulation import apply_receives as port_apply_receives


def as_bytes(a) -> np.ndarray:
    """The raw bytes of an array or tensor (bfloat16 included)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    a = np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8)


# (defense, d, N): N = 20 000 at the paper's widths; at d = 6 and 8, where
# XLA sums some rows unfused (faults.screen_split), N = 20 003 (two
# workgroups on an 8-CPU host, N odd: every row fused; 19 998 rows
# vectorised on one CPU) and N = 13 (one scalar loop)
APPLY_RECEIVES_CASES = [
    pytest.param(defense, d, n, id="-".join(map(str, (defense, d) + (
        () if n == 20_000 else (n,)))))
    for d, n in ((10, 20_000), (57, 20_000), (6, 20_003), (6, 13),
                 (8, 20_003), (8, 13))
    for defense in ("norm_clip", "cosine_gate")]


@pytest.mark.parametrize("defense,d,n", APPLY_RECEIVES_CASES)
def test_apply_receives_equals_the_jitted_reference(defense, d, n):
    """The port's ``apply_receives`` against the reference's under
    ``jax.jit``, as its engine runs it (mu): lastModel (the screened,
    possibly rescaled message) and the gated and clipped counts bit for
    bit. The cache rows hold the Pegasos step, which XLA also fuses
    (``decay w + coef x``) and the port rounds apart, so they are held to
    a float tolerance."""
    c, k = 10, (1 if d == 10 else 2)
    rng = np.random.default_rng(d)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    i = lambda lo, hi, *s: rng.integers(lo, hi, size=s).astype(np.int32)
    a = dict(last_w=f(n, d) * 0.3, last_t=i(1, 40, n), cache_w=f(n, c, d),
             cache_t=i(0, 40, n, c), ptr=i(1, 3 * c, n), count=i(1, c + 1, n),
             msg_w=f(k, n, d) * (3.0 if defense == "norm_clip" else 1.0),
             msg_t=i(1, 40, k, n), valid=rng.random((k, n)) < 0.9, x=f(n, d),
             y=np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32))
    jfn = jax.jit(functools.partial(
        jax_apply_receives, variant="mu",
        update=jax_make_update("pegasos", lam=1e-3), defense=defense))
    J = {key: jnp.asarray(v) for key, v in a.items()}
    jw, jt, jcache, jg, jc = jfn(
        J["last_w"], J["last_t"], JCache(J["cache_w"], J["cache_t"],
                                         J["ptr"], J["count"]),
        J["msg_w"], J["msg_t"], J["valid"], J["x"], J["y"])
    T = {key: torch.from_numpy(v) for key, v in a.items()}
    pw, pt, pcache, pg, pc = port_apply_receives(
        T["last_w"], T["last_t"], ModelCache(T["cache_w"], T["cache_t"],
                                             T["ptr"], T["count"]),
        T["msg_w"], T["msg_t"], T["valid"], T["x"], T["y"], variant="mu",
        update=port_make_update("pegasos", lam=1e-3), defense=defense)
    assert np.array_equal(as_bytes(pw), as_bytes(jw))
    for got, want in ((pt, jt), (pg, jg), (pc, jc), (pcache.t, jcache.t),
                      (pcache.ptr, jcache.ptr), (pcache.count, jcache.count)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(np.asarray(jg if defense == "cosine_gate" else jc).sum()) > n // 40
    np.testing.assert_allclose(pcache.w.numpy(), np.asarray(jcache.w),
                               rtol=1e-5, atol=1e-6)
