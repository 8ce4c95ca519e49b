"""Blocked causal / sliding-window / grouped-query flash attention forward.

Counterpart of ``repro/kernels/flash_attention.py`` (the Pallas TPU kernel
``flash_attention``, the ``attn_impl="pallas"`` path of the LM stack's
full-sequence attention, forward only). For q (B, S, H, hd) and k, v (B, S,
KV, hd), query head h attending over kv head ``h // (H // KV)``: logits
scaled by ``1/sqrt(hd)``, masked (-1e30) outside the causal band and the
window (``qpos - kpos``, no offset: Sq = Sk), an online softmax with its
running max, sum and accumulator in f32 over inputs upcast to f32, masked
probabilities 0, and the sum clamped at 1e-30, so a fully masked row gives
0; the output in q's dtype.

``flash_attention`` dispatches on the tensors' device. CPU tensors go to
``flash_attention_plain`` beside it. CUDA tensors go to one of two
hand-written kernels (built by ``nvcc`` for sm_90a at first use), chosen
by ``route`` before the launch, from dtype, head_dim, strides and
alignment alone:

- ``"tensor_core"``: ``csrc/flash_attention_hopper.cu``, wgmma products
  fed by TMA, for bfloat16 at head_dim 64, 128 or 256 whose q, k and v
  TMA can read (every stride but head_dim's a positive multiple of 8
  elements, each base 16-byte aligned). It rounds P to bf16 before P V,
  as FlashAttention-2/3 and the port's plain attention path do. A block
  takes 128 queries; key tiles are 128 wide at hd 64 and 128 and 64 wide
  at hd 256 (recurrentgemma's local attention), where the Q tile (64 KB)
  and two K/V slots (64 KB each) take 197,672 bytes of shared memory and
  a consumer thread's share of the 64 x 256 output accumulator takes 128
  registers: there a producer warpgroup gives its registers to the two
  consumer warpgroups (240 a thread, ``setmaxnreg``), so nothing spills;
- ``"cuda_core"``: ``csrc/flash_attention.cu``, float32 products on the
  CUDA cores, for everything else (float32, other head_dims up to 256,
  views TMA cannot read), with P in float32.

Both read q, k and v where they lie, through their strides. There is no
fallback: a CUDA tensor reaches its route's kernel or an exception. The
kernels' tiles are their own; the TPU kernel's ``blk_q``/``blk_k`` and its
padding of S and hd are TPU tiling rules and have no counterpart.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.gossip_cycle import (_FLOAT, _INT, _VP, _entry,
                                              _raise_on, _stream, refuse_grad)

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
ROUTES = ("tensor_core", "cuda_core")
TENSOR_CORE_HEAD_DIMS = (64, 128, 256)


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None):
    """What the kernel computes, in plain PyTorch: the whole softmax at
    once (the kernel's tile-by-tile rescaling is the same function up to
    rounding)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.float().reshape(b, s, kv, h // kv, hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * (
        1.0 / math.sqrt(hd))
    pos = torch.arange(s, device=q.device)
    diff = pos[:, None] - pos[None, :]
    mask = torch.ones_like(diff, dtype=torch.bool)
    if causal:
        mask &= diff >= 0
    if window is not None:
        mask &= diff < window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.where(mask, torch.exp(logits - logits.amax(-1, keepdim=True)),
                    0.0)
    l = p.sum(-1).clamp_min(1e-30)                        # (b, g, r, q)
    acc = torch.einsum("bgrqk,bkgd->bgrqd", p, v.float())
    out = (acc / l[..., None]).permute(0, 3, 1, 2, 4)     # (b, q, g, r, d)
    return out.reshape(b, s, h, hd).to(q.dtype)


def _check(q, k, v, window):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("expected q (B, S, H, hd), k and v (B, S, KV, hd)")
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if tuple(k.shape) != (b, s, kv, hd) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, S, KV, hd) = "
                         f"{(b, s, kv, hd)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} kv heads")
    for name, a in (("k", k), ("v", v)):
        if a.device != q.device:
            raise ValueError(f"{name} is on {a.device}, q on {q.device}")
        if a.dtype != q.dtype:
            raise TypeError(f"{name} is {a.dtype}, q {q.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def route(q, k, v) -> str:
    """Which kernel serves these tensors on CUDA: ``"tensor_core"`` for
    bfloat16 at head_dim 64, 128 or 256 with head_dim contiguous, every other
    stride of q, k and v a positive multiple of 8 elements and each
    ``data_ptr`` a multiple of 16 (what TMA reads), else ``"cuda_core"``."""
    if q.dtype != torch.bfloat16 or q.shape[3] not in TENSOR_CORE_HEAD_DIMS:
        return "cuda_core"
    for a in (q, k, v):
        if (a.stride(3) != 1 or a.data_ptr() % 16
                or any(st <= 0 or st % 8 for st in a.stride()[:3])):
            return "cuda_core"
    return "tensor_core"


def _launch(q, k, v, causal: bool, window, kernel: str):
    b, s, h, hd = q.shape
    if kernel == "tensor_core":
        fn, err = _entry("flash_attention_hopper",
                         "flash_attention_hopper_forward",
                         (_VP,) * 4 + (_INT,) * 5 + (_VP, _INT, _INT, _FLOAT,
                                                     _VP))
        dims = (b, s, h, k.shape[2], hd)
    else:
        if q.dtype not in _DTYPES:
            raise TypeError(f"the flash kernel takes float32 or bfloat16, "
                            f"got {q.dtype}")
        if hd > MAX_HEAD_DIM:
            raise ValueError(f"head_dim {hd} exceeds the kernel's "
                             f"{MAX_HEAD_DIM}")
        if b * h > 65535:
            raise ValueError(f"B * H = {b * h} exceeds the kernel's grid")
        for name, a in (("q", q), ("k", k), ("v", v)):
            if a.stride(3) != 1:
                raise ValueError(f"{name}'s head_dim must be contiguous")
        fn, err = _entry("flash_attention", "flash_attention_forward",
                         (_VP,) * 4 + (_INT,) * 6 + (_VP, _INT, _INT, _FLOAT,
                                                     _VP))
        dims = (_DTYPES[q.dtype], b, s, h, k.shape[2], hd)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = (ctypes.c_int64 * 12)(*(st for a in (q, k, v, out)
                                      for st in a.stride()[:3]))
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  *dims, ctypes.cast(strides, ctypes.c_void_p), int(causal),
                  0 if window is None else int(window),
                  1.0 / float(hd) ** 0.5, _stream(q))
    _raise_on(code, err, f"flash_attention ({kernel})")
    _FLASH.launches += 1
    _FLASH.route_launches[kernel] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """q (B, S, H, hd), k and v (B, S, KV, hd) with H % KV == 0, on one
    device and of one dtype -> (B, S, H, hd) in q's dtype."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise NotImplementedError(f"no flash-attention kernel for device "
                                  f"{q.device}")
    refuse_grad("flash_attention", q, k, v)
    return _launch(q, k, v, causal, window, route(q, k, v))


def cuda_core_smem_bytes(hd: int) -> int:
    """The dynamic shared memory a block of the CUDA-core kernel asks for
    at head_dim ``hd`` (at most ``MAX_HEAD_DIM``); builds the kernel if
    needed."""
    fn, _ = _entry("flash_attention", "flash_attention_smem_bytes", (_INT,))
    return fn(hd)


def tensor_core_smem_bytes(hd: int) -> int:
    """The dynamic shared memory a block of the tensor-core kernel asks
    for at head_dim ``hd`` (one of ``TENSOR_CORE_HEAD_DIMS``); builds the
    kernel if needed."""
    fn, _ = _entry("flash_attention_hopper",
                   "flash_attention_hopper_smem_bytes", (_INT,))
    return fn(hd)


# Kernel launches so far, in all and by route; only the CUDA path counts.
# Bound to the wrapper object itself, so the counts survive a caller
# wrapping the module attribute.
flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
_FLASH = flash_attention
