"""Kernel #8's two CUDA routes, checked without a card.

``repro_torch.kernels.flash_attention.route`` picks the tensor-core kernel
(``csrc/flash_attention_hopper.cu``) or the CUDA-core one
(``csrc/flash_attention.cu``) from dtype, head_dim, strides and alignment
alone; here it is called on CPU tensors of every kind it sorts.

The tensor-core kernel rounds P to bf16 before P V, which the TPU kernel
and the CUDA-core kernel do not. ``emulate_tensor_core`` repeats its
arithmetic on the CPU (query tiles of 128, key tiles of 128 or, at head_dim
256, of 64, the band of key tiles,
an online softmax in float32 in base 2 with P rounded to bf16, float32
accumulation) and is held, on bf16 inputs from numpy, to the JAX Pallas
kernel in interpret mode (where its zero padding is hidden, as in
``tests/test_torch_kernels_ops.py``), to ``attention_ref`` and to the
port's plain version, within the bf16 tolerance ``chip_smoke.py`` holds
the kernel to on the card: atol 3e-2 and rtol 2^-7 (one bf16 rounding of
an output above 4).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa

BF16_TOL = dict(rtol=2.0 ** -7, atol=3e-2)
TILE = 128
KEY_TILE = {64: 128, 128: 128, 256: 64}   # keys a K/V tile, by head_dim


def emulate_tensor_core(q, k, v, *, causal=True, window=None):
    """The tensor-core kernel's arithmetic in float32 on the CPU: q, k, v
    bf16 (B, S, heads, hd) -> (B, S, H, hd) bf16."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)                        # (b, h, s, hd)
    kf, vf = (a.float().permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
              for a in (k, v))
    c = (1.0 / math.sqrt(hd)) * math.log2(math.e)
    bk = KEY_TILE[hd]
    out = torch.zeros(b, h, s, hd)
    for q0 in range(0, s, TILE):
        rows = torch.arange(q0, min(q0 + TILE, s))
        k_lo, k_hi = 0, s
        if causal:
            k_hi = min(s, q0 + TILE)
        if window is not None:
            k_lo = max(0, q0 - (window - 1))
        m = torch.full((b, h, len(rows)), -math.inf)
        l = torch.zeros(b, h, len(rows))
        o = torch.zeros(b, h, len(rows), hd)
        for k0 in range(k_lo // bk * bk, k_hi, bk):
            # the kernel's tile also holds zero keys past S, masked
            keys = torch.arange(k0, min(k0 + bk, s))
            sc = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
            diff = rows[:, None] - keys[None, :]
            mask = torch.ones_like(diff, dtype=torch.bool)
            if causal:
                mask &= diff >= 0
            if window is not None:
                mask &= diff < window
            sc = torch.where(mask, sc, -math.inf)
            mx = torch.maximum(m, sc.amax(-1))
            ms = torch.where(mx == -math.inf, 0.0, mx) * c
            alpha = torch.exp2(m * c - ms)
            p = torch.exp2(sc * c - ms[..., None])
            l = l * alpha + p.sum(-1)
            o = (o * alpha[..., None]
                 + p.to(torch.bfloat16).float() @ vf[:, :, keys])
            m = mx
        out[:, :, rows] = o / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def bf16_qkv(seed, b, s, h, kv, hd):
    """bf16 q, k, v from numpy normal draws, as torch tensors."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape,
                                                      dtype=np.float32))
                 .to(torch.bfloat16)
                 for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))


def to_jax(a):
    return jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)


def assert_bf16_close(got, want):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------


def contiguous(b, s, heads, hd, dtype=torch.bfloat16):
    return torch.zeros(b, s, heads, hd, dtype=dtype)


def heads_first(b, s, heads, hd, dtype=torch.bfloat16):
    """A (B, S, heads, hd) view of a (B, heads, S, hd) tensor."""
    return torch.zeros(b, heads, s, hd, dtype=dtype).transpose(1, 2)


def unaligned(b, s, heads, hd, dtype=torch.bfloat16):
    """Contiguous, starting one element past a 16-byte boundary."""
    buf = torch.zeros(b * s * heads * hd + 1, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    return buf[1:].view(b, s, heads, hd)


def odd_row_stride(b, s, heads, hd, dtype=torch.bfloat16):
    """Rows of heads * hd + 4 elements: the S stride is no multiple of 8."""
    row = heads * hd + 4
    return torch.zeros(b * s * row, dtype=dtype).as_strided(
        (b, s, heads, hd), (s * row, row, hd, 1))


def broadcast_batch(b, s, heads, hd, dtype=torch.bfloat16):
    """One batch row expanded: a zero B stride."""
    return torch.zeros(1, s, heads, hd, dtype=dtype).expand(b, s, heads, hd)


def hd_strided(b, s, heads, hd, dtype=torch.bfloat16):
    """head_dim not contiguous."""
    return torch.zeros(b, s, hd, heads, dtype=dtype).transpose(2, 3)


@pytest.mark.parametrize("hd", fa.TENSOR_CORE_HEAD_DIMS)
@pytest.mark.parametrize("make", [contiguous, heads_first])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (16, 2)])
def test_route_takes_tensor_cores_for_tma_readable_bf16(hd, make, h, kv):
    q, k, v = make(2, 37, h, hd), make(2, 37, kv, hd), make(2, 37, kv, hd)
    assert fa.route(q, k, v) == "tensor_core"


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 64),
                                      (torch.float32, 128),
                                      (torch.float32, 256),
                                      (torch.bfloat16, 48),
                                      (torch.bfloat16, 32)])
def test_route_keeps_cuda_cores_for_other_dtypes_and_head_dims(dtype, hd):
    q, k, v = (contiguous(2, 37, heads, hd, dtype) for heads in (4, 2, 2))
    assert fa.route(q, k, v) == "cuda_core"


@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("make", [unaligned, odd_row_stride, broadcast_batch,
                                  hd_strided])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_route_keeps_cuda_cores_for_views_tma_cannot_read(make, which, hd):
    """One of q, k, v unaligned, with an S stride no multiple of 8, a zero
    stride, or head_dim not contiguous."""
    qkv = [contiguous(2, 40, heads, hd) for heads in (4, 2, 2)]
    qkv[which] = make(2, 40, qkv[which].shape[2], hd)
    assert fa.route(*qkv) == "cuda_core"


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    q, k, v = bf16_qkv(0, 1, 37, 4, 2, 128)
    assert fa.route(q, k, v) == "tensor_core"
    total = fa.flash_attention.launches
    routes = dict(fa.flash_attention.route_launches)
    got = fa.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, fa.flash_attention_plain(q, k, v, causal=True))
    assert fa.flash_attention.launches == total
    assert fa.flash_attention.route_launches == routes


# ---------------------------------------------------------------------------
# the tensor-core kernel's arithmetic (P in bf16) against the references
# ---------------------------------------------------------------------------

# (B, S, H, KV, hd, causal, window): ragged S (1, 37, 300), a window, and
# H/KV 1, 2 and 8; at hd 256 (64-key tiles) one kv head, as recurrentgemma
CASES = [
    (1, 128, 2, 2, 64, True, None),
    (2, 37, 4, 2, 128, True, None),
    (1, 256, 8, 1, 128, True, 64),
    (1, 256, 4, 2, 64, False, None),
    (1, 300, 8, 8, 64, True, None),
    (1, 300, 16, 2, 128, True, 64),
    (2, 37, 4, 2, 128, False, None),
    (1, 300, 8, 1, 64, False, 64),
    (2, 1, 8, 1, 128, True, None),
    (1, 300, 2, 2, 128, False, None),
    (1, 300, 4, 1, 256, True, 96),
    (2, 37, 2, 1, 256, True, None),
    (1, 256, 2, 1, 256, False, None),
]


def pallas_hides_padding(s, causal):
    """The JAX kernel (blocks of 128) attends to its zero-padded keys when
    it is not causal and S is no multiple of its block."""
    return causal or s <= TILE or s % TILE == 0


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", CASES)
def test_emulated_tensor_core_kernel_matches_references(B, S, H, KV, hd,
                                                        causal, window):
    q, k, v = bf16_qkv(B * S + H + hd, B, S, H, KV, hd)
    got = emulate_tensor_core(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = jref.attention_ref(*map(to_jax, (q, k, v)), causal=causal,
                              window=window)
    assert_bf16_close(got, want)
    assert_bf16_close(got, fa.flash_attention_plain(q, k, v, causal=causal,
                                                    window=window))
    if pallas_hides_padding(S, causal):
        pallas = jfa.flash_attention(*map(to_jax, (q, k, v)), causal=causal,
                                     window=window, blk_q=TILE, blk_k=TILE,
                                     interpret=True)
        assert_bf16_close(got, pallas)


def test_emulated_p_rounding_is_within_its_bound():
    """Rounding P to bf16 moves an output by at most about 2^-9 max|v| (one
    half-ulp of every p), before the output's own rounding: measured in
    float32 against the same arithmetic with P in float32."""
    q, k, v = bf16_qkv(5, 1, 300, 4, 2, 128)
    rounded = emulate_tensor_core(q, k, v, causal=True).float()
    exact = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                     causal=True)
    bound = 2.0 ** -9 * float(v.float().abs().max())
    # the outputs' bf16 rounding adds up to 2^-9 of each output
    slack = 2.0 ** -9 * exact.abs() + 1e-6
    assert bool(((rounded - exact).abs() <= bound + slack).all())
    assert float((rounded - exact).abs().max()) > 0.0
