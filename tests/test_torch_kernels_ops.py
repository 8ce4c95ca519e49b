"""Kernels #6, #7 and #8 through ``repro_torch.kernels.ops`` on CPU tensors
(their plain versions) against the JAX Pallas kernels in interpret mode,
on the same numpy inputs from a seed, over the sweeps and at the
tolerances of ``tests/test_kernels.py``: the Pegasos and merge steps at
rtol 2e-5 / atol 1e-5 with ``t`` exact; flash attention at 2e-4 in f32 and
3e-2 in bf16.

The JAX flash kernel attends to its zero-padded keys when it is not causal
and S is not a multiple of its block (ROADMAP queue 3), so it is held only
where S divides into its blocks or the causal mask hides the padding; the
port's plain version is held to ``attention_ref`` at the ragged shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import gossip_merge as jgm
from repro.kernels import pegasos_update as jpu
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gossip_merge as gm
from repro_torch.kernels import ops
from repro_torch.kernels import pegasos_update as pu
from repro_torch.kernels import ref


def rows(seed, n, d, models=1):
    """(N, d) models with t in [0, 100), x, and y ±1, as numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(models):
        out += [rng.standard_normal((n, d), dtype=np.float32),
                rng.integers(0, 100, n).astype(np.int32)]
    x = rng.standard_normal((n, d), dtype=np.float32)
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    return out + [x, y]


def assert_step(got, want):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("n,d", [(1, 8), (7, 57), (32, 128), (33, 300),
                                 (5, 1000), (1000, 10), (3, 9947)])
@pytest.mark.parametrize("lam", [0.1, 1e-3])
def test_pegasos_update_matches_pallas_kernel(n, d, lam):
    w, t, x, y = rows(n * d, n, d)
    want = jpu.pegasos_update(jnp.asarray(w), jnp.asarray(t), jnp.asarray(x),
                              jnp.asarray(y), lam=lam, interpret=True)
    before = pu.pegasos_update.launches
    got = ops.pegasos_update(*map(torch.from_numpy, (w, t, x, y)), lam=lam)
    assert_step(got, want)
    assert pu.pegasos_update.launches == before     # no kernel on the CPU


@pytest.mark.parametrize("n,d", [(4, 16), (19, 257), (8, 512), (1000, 10),
                                 (3, 9947)])
def test_merge_update_matches_pallas_kernel(n, d):
    w1, t1, w2, t2, x, y = rows(n + d, n, d, models=2)
    want = jgm.merge_update(*map(jnp.asarray, (w1, t1, w2, t2, x, y)),
                            lam=0.01, interpret=True)
    before = gm.merge_update.launches
    got = ops.merge_update(*map(torch.from_numpy, (w1, t1, w2, t2, x, y)),
                           lam=0.01)
    assert_step(got, want)
    assert gm.merge_update.launches == before


def test_merge_update_is_pegasos_step_of_the_average():
    w1, t1, w2, t2, x, y = map(torch.from_numpy, rows(3, 50, 20, models=2))
    got = ops.merge_update(w1, t1, w2, t2, x, y, lam=0.05)
    want = ops.pegasos_update((w1 + w2) / 2.0, torch.maximum(t1, t2), x, y,
                              lam=0.05)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def qkv(seed, b, s, h, kv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd), dtype=np.float32),
            rng.standard_normal((b, s, kv, hd), dtype=np.float32),
            rng.standard_normal((b, s, kv, hd), dtype=np.float32))


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 128, 2, 2, 32),      # MHA
    (2, 128, 4, 2, 64),      # GQA 2:1
    (1, 256, 8, 1, 64),      # MQA
])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
def test_flash_attention_matches_pallas_kernel(B, S, H, KV, hd, causal,
                                               window):
    q, k, v = qkv(B * S + H, B, S, H, KV, hd)
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                               window=window, blk_q=64, blk_k=64,
                               interpret=True)
    before = fa.flash_attention.launches
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    assert fa.flash_attention.launches == before


def test_flash_attention_bf16_matches_pallas_kernel():
    q, k, v = qkv(0, 1, 128, 2, 1, 64)
    want = jfa.flash_attention(*(jnp.asarray(a).astype(jnp.bfloat16)
                                 for a in (q, k, v)), causal=True, blk_q=64,
                               blk_k=64, interpret=True)
    got = ops.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                                for a in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2)


@pytest.mark.parametrize("S,window", [(64, None), (100, None), (100, 16)])
def test_flash_attention_odd_head_dim_matches_pallas_kernel(S, window):
    """hd = 48, which the TPU kernel pads to 128 lanes; a ragged S (100)
    under the causal mask, which hides the TPU kernel's padded keys."""
    q, k, v = qkv(3 + S, 1, S, 2, 2, 48)
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                               window=window, blk_q=32, blk_k=32,
                               interpret=True)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("S,causal,window", [(1, True, None),
                                             (37, True, None),
                                             (100, False, None),
                                             (100, False, 16),
                                             (70, True, 5)])
def test_flash_attention_plain_matches_attention_ref(S, causal, window):
    """Ragged and one-token sequences, including the non-causal ones the
    TPU kernel gets wrong: the port against the JAX ``attention_ref``."""
    q, k, v = qkv(S, 2, S, 4, 2, 16)
    want = jref.attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal,
                              window=window)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("sq,sk,causal,window", [(8, 8, True, None),
                                                 (1, 20, True, None),
                                                 (5, 20, True, 6),
                                                 (5, 20, False, None)])
def test_attention_ref_matches_reference(sq, sk, causal, window):
    """The port's oracle with the decode alignment (the last Sq keys align
    with the queries) against the JAX one."""
    rng = np.random.default_rng(sq * sk)
    q = rng.standard_normal((2, sq, 4, 16), dtype=np.float32)
    k = rng.standard_normal((2, sk, 1, 16), dtype=np.float32)
    v = rng.standard_normal((2, sk, 1, 16), dtype=np.float32)
    want = jref.attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal,
                              window=window)
    got = ref.attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal,
                            window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_wrappers_reject_bad_operands():
    w, t, x, y = map(torch.from_numpy, rows(0, 4, 6))
    with pytest.raises(TypeError):
        ops.pegasos_update(w.double(), t, x, y, lam=0.1)
    with pytest.raises(ValueError):
        ops.merge_update(w, t, w[:3], t[:3], x, y, lam=0.1)
    q, k, v = map(torch.from_numpy, qkv(0, 1, 8, 3, 2, 8))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v)                 # 3 heads over 2
    q, k, v = map(torch.from_numpy, qkv(0, 1, 8, 2, 1, 8))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, window=0)
