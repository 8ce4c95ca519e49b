"""The port's threefry draws (``repro_torch.random``) against ``jax.random``.

The protocol's routing (destination, delay, drop) comes from these draws,
so every function must equal JAX's default partitionable threefry bit for
bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sharded_engine import _draw_chunk as jax_draw_chunk
from repro.core.sharded_engine import key_schedule as jax_key_schedule
from repro_torch import random
from repro_torch.core import sharded_engine as pt_engine

SEEDS = [0, 1, 7, 2 ** 31 - 1]
SIZES = [1, 2, 3, 33, 64, 1000, 4097]


def pt_key(seed):
    return random.key(seed, device="cpu")


def as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def test_threefry_partitionable_is_the_reference_scheme():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches(seed):
    want = np.asarray(jax.random.key_data(jax.random.key(seed)))
    assert np.array_equal(as_u32(pt_key(seed)), want)


@pytest.mark.parametrize("num", [2, 3, 4, 33])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches(seed, num):
    want = np.asarray(jax.random.key_data(
        jax.random.split(jax.random.key(seed), num)))
    got = random.split(pt_key(seed), num)
    assert got.shape == (num, 2)
    assert np.array_equal(as_u32(got), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_match(seed):
    jk = jax.random.key(seed)
    for shape in [(s,) for s in SIZES] + [(3, 11), (2, 5, 7)]:
        want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
        got = random.random_bits(pt_key(seed), shape)
        assert got.shape == shape
        assert np.array_equal(as_u32(got), want), shape


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_bitwise(seed):
    jk = jax.random.key(seed)
    for s in SIZES:
        want = np.asarray(jax.random.uniform(jk, (s,)))
        got = random.uniform(pt_key(seed), (s,))
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy().view(np.uint32),
                              want.view(np.uint32)), s


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_matches(seed):
    jk = jax.random.key(seed)
    for n in SIZES:
        for lo, hi in [(0, n - 1), (1, n + 1), (-3, n)]:
            want = np.asarray(jax.random.randint(jk, (n,), lo, hi))
            got = random.randint(pt_key(seed), (n,), lo, hi)
            assert got.dtype == torch.int32
            assert np.array_equal(got.numpy(), want), (n, lo, hi)


@pytest.mark.parametrize("seed", SEEDS)
def test_bernoulli_matches(seed):
    jk = jax.random.key(seed)
    for p in [0.2, 0.5, 0.8]:
        for s in SIZES:
            want = np.asarray(jax.random.bernoulli(jk, p, (s,)))
            got = random.bernoulli(pt_key(seed), p, (s,))
            assert np.array_equal(got.numpy(), want), (p, s)


@pytest.mark.parametrize("n", [2, 33, 1000])
@pytest.mark.parametrize("seed", SEEDS)
def test_permutation_matches(seed, n):
    want = np.asarray(jax.random.permutation(jax.random.key(seed), n))
    got = random.permutation(pt_key(seed), n)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(np.sort(got.numpy()), np.arange(n))


@pytest.mark.parametrize("seed", [0, 7])
def test_key_schedule_matches(seed):
    want = np.asarray(jax.random.key_data(jax_key_schedule(seed, 6)))
    got = pt_engine.key_schedule(seed, 6, "cpu")
    assert np.array_equal(as_u32(got), want)


@pytest.mark.parametrize("sampler,n,drop,delay_max", [
    ("uniform", 64, 0.5, 10),
    ("uniform", 33, 0.0, 1),
    ("matching", 33, 0.2, 3),
    ("matching", 64, 0.0, 1),
])
def test_draw_chunk_tables_match(sampler, n, drop, delay_max):
    T, clock0, seed = 5, 7, 3
    online = np.random.default_rng(0).random((T, n)) < 0.8
    jkeys = jax_key_schedule(seed, clock0 + T)[clock0:]
    want_dst, want_arr = jax_draw_chunk(
        jkeys, jnp.asarray(online), jnp.int32(clock0), n=n, drop=drop,
        delay_max=delay_max, sampler=sampler)
    keys = pt_engine.key_schedule(seed, clock0 + T, "cpu")[clock0:]
    dst, arr = pt_engine._draw_chunk(keys, torch.as_tensor(online), clock0,
                                     n=n, drop=drop, delay_max=delay_max,
                                     sampler=sampler)
    assert dst.dtype == arr.dtype == torch.int32
    assert np.array_equal(dst.numpy(), np.asarray(want_dst))
    assert np.array_equal(arr.numpy(), np.asarray(want_arr))


def f32_bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_f32_bitwise(seed):
    """Every float32 draw equals jax's, the tails too (|x| > 3 is where
    w >= 5 takes erf_inv's second polynomial, through the square root)."""
    shape = (64, 3125)
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    got = random.normal(pt_key(seed), shape, torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert np.array_equal(f32_bits(got), want.view(np.uint32))
    assert (np.abs(want) > 3).any()


def _around(v: float, n: int = 3) -> list:
    """float32 ``v`` and its ``n`` neighbours on each side."""
    c = np.float32(v)
    out, lo, hi = [c], c, c
    for _ in range(n):
        lo = np.nextafter(lo, np.float32(-np.inf))
        hi = np.nextafter(hi, np.float32(np.inf))
        out += [lo, hi]
    return out


_EDGE = float(np.float32(np.sqrt(2) - 1))
_TINY = float(np.finfo(np.float32).tiny)
_SUB = [5e-45, 1e-40, _TINY / 2, float(np.nextafter(np.float32(_TINY),
                                                    np.float32(0)))]
LOG1P_CASES = {
    "small_branch_edge": _around(_EDGE) + _around(-_EDGE),
    "minus_one": _around(-1.0) + [-2.0, -np.inf],
    "zeros": [0.0, -0.0],
    "subnormals": _SUB + [-v for v in _SUB],
    "tiny_normals": _around(_TINY) + _around(-_TINY) + [1e-20, -1e-20],
    "erf_inv_domain": list(-np.random.default_rng(0).uniform(
        -1, 1, 4096).astype(np.float32) ** 2),
    "both_branches": list(np.random.default_rng(1).uniform(
        -1, 3, 4096).astype(np.float32)),
    "large_and_special": [1.0, 7.5, 1e10, 3e38, np.inf, np.nan],
}
LOG_CASES = {
    "erf_inv_domain": list(np.random.default_rng(2).uniform(
        0, 0.586, 4096).astype(np.float32)),
    "reduction_edge": _around(np.sqrt(0.5)) + _around(np.sqrt(2)) +
    _around(1.0) + _around(0.5) + _around(0.586),
    "zeros_and_negatives": [0.0, -0.0, -1.0, -_TINY, -np.inf, np.nan],
    "subnormals": _SUB,
    "tiny_normals": _around(_TINY) + [1e-30, 1e-10],
    "wide": list(np.exp(np.random.default_rng(3).uniform(
        -87, 88, 4096)).astype(np.float32)),
    "large_and_special": [3.4e38, float(np.finfo(np.float32).max), np.inf],
}


@pytest.mark.parametrize("name,inputs", [
    pytest.param(name, inputs, id=f"{name}-{case}")
    for name, cases in (("log1p", LOG1P_CASES), ("log", LOG_CASES))
    for case, inputs in cases.items()])
def test_xla_log_functions_equal_jit_bitwise(name, inputs):
    """``log1p_xla`` and ``log_xla`` are XLA's float32 functions on the CPU
    bit for bit, NaN words included: on both of log1p's branches, at its
    edge +-(sqrt(2) - 1) and at -1, at +-0 and at subnormals (which XLA's
    arithmetic reads as zero), and where log's reduction switches."""
    x = np.asarray(inputs, dtype=np.float32)
    want = np.asarray(jax.jit(getattr(jnp, name))(x))
    got = getattr(random, f"{name}_xla")(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert np.array_equal(f32_bits(got), want.view(np.uint32)), (
        x[f32_bits(got) != want.view(np.uint32)])


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_bf16_bitwise(seed):
    """bfloat16 draws take 8 random bits, of which the top 7 fill the
    mantissa: each of the 128 words equals jax's (measured: all of
    200,000 draws a seed)."""
    shape = (200, 1000)
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape,
                                        jnp.bfloat16))
    got = random.normal(pt_key(seed), shape, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          want.view(np.int16))
    assert len(np.unique(want.view(np.int16))) == 128


def test_erf_inv_ends_and_dtype_check():
    x = torch.tensor([-1.0, 0.0, 1.0])
    assert random.erf_inv(x).tolist() == [-float("inf"), 0.0, float("inf")]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        random.normal(pt_key(0), (2,), torch.float16)
