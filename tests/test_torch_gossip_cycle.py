"""The fused receive step: the port's plain version against the JAX Pallas
kernel (interpret mode) and against the reference ``apply_receives``.

Integer outputs must be equal; floats within ``rtol=1e-5, atol=1e-6``
(``apply_receives`` rounds the Pegasos step as ``eta*(y*x)``, the kernel as
``(eta*y)*x``, and the margins are summed in different orders). The CUDA
kernel itself runs only on the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it to the plain version there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import simulation as jsim
from repro.core.cache import ModelCache as JCache
from repro.core.learners import make_update
from repro.kernels.gossip_cycle import fused_receive_apply as jax_fused
from repro_torch.kernels import gossip_cycle as pt

LAM = 1e-3
N = 37


def make_inputs(seed, n, d, c, k):
    """A mid-run state: random models, counters, ring pointers and a
    random valid mask (numpy, so both packages see the same inputs)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    i = lambda lo, hi, *s: rng.integers(lo, hi, size=s).astype(np.int32)
    return dict(
        last_w=f(n, d), last_t=i(0, 40, n), cache_w=f(n, c, d),
        cache_t=i(0, 40, n, c), ptr=i(1, 3 * c, n), count=i(1, c + 1, n),
        msg_w=f(k, n, d) * 3, msg_t=i(0, 40, k, n),
        valid=(rng.random((k, n)) < 0.6).astype(np.int32),
        x=f(n, d), y=np.where(rng.random(n) < 0.5, -1.0, 1.0)
        .astype(np.float32))


ORDER = ("last_w", "last_t", "cache_w", "cache_t", "ptr", "count", "msg_w",
         "msg_t", "valid", "x", "y")
OUT = ORDER[:6]


def run_plain(inp, variant):
    args = [torch.tensor(inp[k]) for k in ORDER]
    out = pt.fused_receive_apply(*args, variant=variant, lam=LAM)
    assert all(a is b for a, b in zip(out, args[:6]))   # in place
    return {k: v.numpy() for k, v in zip(OUT, out)}


def assert_state_equal(got, want):
    for k in OUT:
        w = np.asarray(want[k])
        if w.dtype == np.int32:
            assert np.array_equal(got[k], w), k
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("d", [10, 57, 130])
@pytest.mark.parametrize("c", [3, 10])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("variant", ["rw", "mu", "um"])
def test_plain_matches_pallas_kernel_and_apply_receives(variant, k, c, d):
    inp = make_inputs(1000 * k + 10 * c + d, N, d, c, k)
    got = run_plain(inp, variant)

    j = {key: jnp.asarray(v) for key, v in inp.items()}
    out = jax_fused(j["last_w"], j["last_t"], j["cache_w"], j["cache_t"],
                    j["ptr"], j["count"], j["msg_w"], j["msg_t"], j["valid"],
                    j["x"], j["y"], variant=variant, lam=LAM, interpret=True)
    assert_state_equal(got, dict(zip(OUT, out[:6])))

    lw, lt, cache, _, _ = jsim.apply_receives(
        j["last_w"], j["last_t"],
        JCache(j["cache_w"], j["cache_t"], j["ptr"], j["count"]),
        j["msg_w"], j["msg_t"], j["valid"] > 0, j["x"], j["y"],
        variant=variant, update=make_update("pegasos", lam=LAM))
    assert_state_equal(got, dict(zip(OUT, (lw, lt, *cache))))


def test_more_rounds_than_slots_overwrite_in_order():
    """K > C with every round valid: round k writes slot (ptr + k) % C, so
    the last C rounds survive and ptr/count advance by K and to C."""
    inp = make_inputs(3, 5, 4, 2, 5)
    inp["valid"][:] = 1
    got = run_plain(inp, "rw")
    assert np.array_equal(got["ptr"], inp["ptr"] + 5)
    assert np.array_equal(got["count"], np.full(5, 2))
    assert np.array_equal(got["last_w"], inp["msg_w"][-1])
    rows = np.arange(5)
    assert np.array_equal(got["cache_t"][rows, (inp["ptr"] + 4) % 2],
                          inp["msg_t"][-1] + 1)


def test_cpu_tensors_run_the_plain_version_without_launching():
    before = pt.fused_receive_apply.launches
    inp = make_inputs(0, N, 10, 10, 4)
    want = run_plain(inp, "mu")
    args = [torch.tensor(inp[k]) for k in ORDER]
    out = pt.fused_receive_apply_plain(*args, variant="mu", lam=LAM)
    assert_state_equal({k: v.numpy() for k, v in zip(OUT, out)}, want)
    assert pt.fused_receive_apply.launches == before == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "variant",
                                 "wire", "defense"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = {k: torch.tensor(v) for k, v in make_inputs(0, 8, 6, 3, 2).items()}
    kw = dict(variant="mu", lam=LAM)
    err = ValueError
    if bad == "dtype":
        args["last_t"] = args["last_t"].long()
        err = TypeError
    elif bad == "shape":
        args["y"] = args["y"][:-1]
    elif bad == "contiguous":
        args["x"] = args["x"].t().contiguous().t()
    elif bad == "variant":
        kw["variant"] = "avg"
    elif bad == "wire":            # the quantized wire modes are not ported
        kw["wire"] = "int8"
        err = TypeError
    else:                          # nor are the defense screens
        kw["defense"] = "norm_clip"
        err = TypeError
    with pytest.raises(err):
        pt.fused_receive_apply(*(args[k] for k in ORDER), **kw)
