"""Adversarial-node fault injection and robust merge defenses.

Counterpart of ``repro/core/faults.py``:

* ``FAULT_MODELS``: a seed-chosen Byzantine subset of nodes corrupts every
  model it sends. The model-kind faults (``sign_flip``, ``amplify``,
  ``zero``, ``random_payload``, ``stale_replay``) rewrite the transmitted
  model before the wire encode; the wire-kind ``bitflip`` flips one bit of
  the encoded payload after it.
* ``DEFENSES``: receive-side screens applied per merge round against the
  receiver's current lastModel. ``norm_clip`` rescales an oversized
  payload's L2 norm to a multiple of the receiver's own, ``cosine_gate``
  rejects payloads anti-aligned with it, and both reject non-finite
  payloads.
* Fault draws use ``fault_key`` = ``fold_in(cycle_key, FAULT_FOLD)``, which
  derives a key without consuming from the cycle's ``split(key, 4)``, so a
  fault-free run draws exactly what it drew before faults existed.

Every function takes and returns tensors on one device and gives the
reference's values bit for bit (``apply_defense``'s rescale within the
rounding of its sums where XLA's order is not known); ``byzantine_mask``
is host numpy, as in the reference.

The reference's engines run ``apply_defense`` inside ``jax.jit``, and its
three sums (``sq``, ``rn``, ``dot``) are the jitted order, which XLA on
the CPU picks by the row's width d (measured on 3000-4000 random rows a
width, squares and products, with jax 0.9.0):

* d = 1: the one product;
* 2 <= d <= 32: fused multiply-adds in sequence from +0.0, ``acc =
  fma(a_j, b_j, acc)``, j = 0 ... d - 1, except at 5 <= d <= 8 on the rows
  XLA's vector loop takes, where the products round apart and add in
  sequence (``screen_split``: which rows those are depends on N, d, the
  number of arrays the sum reads and the host's CPU count);
* 33 <= d <= 64: the rounded products in two halves, j < ceil(d/2) and
  the rest, each in sequence from +0.0, then the two added;
* d a multiple of 32: 32-wide chunks, each in sequence, then the chunk
  sums in sequence (at d = 64 the same as two halves);
* every other d: not known; ``torch.sum`` here.

``_screen_sum`` takes the two factors of each term and adds them in that
order, as the receive kernel's screen does on the card. With the square
roots correctly rounded (``_sqrt``) every verdict and rescale then equals
the jitted reference's bit for bit, exact ties included.

The reference's arithmetic flushes subnormal floats to zero (XLA on the
CPU and the TPU both do; PyTorch and CUDA keep them), and the screen's
verdicts are discrete: a ``bitflip`` on a float wire turns a zero
coefficient into a subnormal one, whose product with lastModel decides a
``cosine_gate`` verdict on sign alone. So ``apply_defense`` flushes, as the
reference's arithmetic does, its inputs and every product, ratio and
square root it compares (``_ftz``), and the receive kernel's screen does
the same. Under fusion the flush applies to the inputs and to each fused
result, never to a product that is not rounded; every partial sum is
flushed too.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import random

# the reference's pinned constants (repro/core/faults.py)
FAULT_FOLD = 0x0FA17
BYZANTINE_STREAM_TAG = 0xB12A
SIGN_FLIP_GAMMA = 4.0
AMPLIFY_GAMMA = 8.0
NORM_CLIP_MULT = 2.0
NORM_CLIP_FLOOR = 1.0
COSINE_GATE_THRESHOLD = -0.2
COSINE_GATE_MIN_NORM = 1e-3

DEFENSES = ("none", "norm_clip", "cosine_gate")

# The screen's constants as JAX evaluates them: a Python double (the square
# taken in double), rounded to float32 once where it meets a float32 array.
_F32 = lambda v: float(np.float32(v))
NORM_CLIP_MULT_SQ = _F32(NORM_CLIP_MULT ** 2)
NORM_CLIP_FLOOR_SQ = _F32(NORM_CLIP_FLOOR ** 2)
COSINE_GATE_MIN_NORM_SQ = _F32(COSINE_GATE_MIN_NORM ** 2)
COSINE_GATE_THRESHOLD_F32 = _F32(COSINE_GATE_THRESHOLD)
CLIP_SQ_GUARD = _F32(1e-30)
_FLT_MIN = float(np.finfo(np.float32).tiny)     # smallest normal float32


@dataclass(frozen=True)
class FaultModel:
    """One registered adversarial behavior: ``kind`` "model" rewrites
    ``(send_w, send_t)`` before the encode, "wire" the payload after it."""
    name: str
    kind: str
    description: str


FAULT_MODELS: Dict[str, FaultModel] = {}


def _register(fault: FaultModel) -> FaultModel:
    assert fault.name not in FAULT_MODELS, fault.name
    assert fault.kind in ("model", "wire"), fault.kind
    FAULT_MODELS[fault.name] = fault
    return fault


_register(FaultModel("sign_flip", "model",
                     f"transmit -{SIGN_FLIP_GAMMA:g}*w (scaled sign "
                     "reversal / gradient-reversal attack)"))
_register(FaultModel("amplify", "model",
                     f"transmit {AMPLIFY_GAMMA:g}*w (model amplification)"))
_register(FaultModel("zero", "model",
                     "transmit the zero model (knowledge erasure)"))
_register(FaultModel("random_payload", "model",
                     "transmit uniform noise at the sender's own "
                     "coefficient scale"))
_register(FaultModel("stale_replay", "model",
                     "retransmit the node's oldest cached model "
                     "(tau ~ cache_size receives ago)"))
_register(FaultModel("bitflip", "wire",
                     "flip one uniform random bit of the encoded wire "
                     "payload (honest fault, post-encode)"))


def get_fault(name: Optional[str]) -> Optional[FaultModel]:
    """Resolve a fault-model name; ``None``/"" = no fault injection."""
    if name is None or name == "":
        return None
    try:
        return FAULT_MODELS[name]
    except KeyError:
        raise ValueError(f"unknown fault model {name!r} "
                         f"(expected one of {sorted(FAULT_MODELS)})"
                         ) from None


def check_defense(name: str) -> str:
    if name not in DEFENSES:
        raise ValueError(f"unknown defense {name!r} "
                         f"(expected one of {list(DEFENSES)})")
    return name


def byzantine_mask(seed: int, n: int, frac: float) -> np.ndarray:
    """The static per-run Byzantine subset: ``round(frac * n)`` nodes drawn
    without replacement from ``default_rng(SeedSequence([seed,
    BYZANTINE_STREAM_TAG]))``, a stream of its own so that enabling faults
    shifts no churn or eval draw. Shared by both engines."""
    if not 0.0 <= frac <= 1.0:
        raise ValueError(f"byzantine_frac must be in [0, 1], got {frac}")
    mask = np.zeros(n, bool)
    k = int(round(frac * n))
    if k:
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, BYZANTINE_STREAM_TAG]))
        mask[rng.choice(n, size=k, replace=False)] = True
    return mask


def fault_key(key) -> torch.Tensor:
    """The per-cycle fault key ``fold_in(key, FAULT_FOLD)``; a (T, 2) stack
    of cycle keys gives the (T, 2) fault keys in one call."""
    return random.fold_in(key, FAULT_FOLD)


def _uniform_rows(key, m: int, d: int, rows, n_total: Optional[int]):
    """``uniform(key, (m, d))``, or its rows ``rows`` of the full
    ``(n_total, d)`` draw."""
    if rows is None:
        return random.uniform(key, (m, d))
    return random.sr_noise_for_rows(key, rows, d, n_total)


def corrupt_model(fault: FaultModel, byz, key, w, t, old_w=None, old_t=None,
                  rows=None, n_total: Optional[int] = None):
    """A model-kind fault on the Byzantine rows of a send batch.

    ``w`` (m, d) f32 models about to be sent, ``t`` (m,) int32, ``byz``
    (m,) bool; ``old_w``/``old_t`` (``cache.cache_oldest``) for
    ``stale_replay``. ``random_payload`` draws ``uniform(key, (m, d))``;
    with ``rows`` (global row ids of a subset, ``n_total`` the population)
    it draws the same values at those rows of the full draw."""
    name = fault.name
    if name == "sign_flip":
        cw, ct = -SIGN_FLIP_GAMMA * w, t
    elif name == "amplify":
        cw, ct = AMPLIFY_GAMMA * w, t
    elif name == "zero":
        cw, ct = torch.zeros_like(w), t
    elif name == "random_payload":
        scale = torch.amax(torch.abs(w), dim=-1, keepdim=True)
        u = _uniform_rows(key, w.shape[0], w.shape[-1], rows, n_total)
        cw, ct = (2.0 * u - 1.0) * scale, t
    elif name == "stale_replay":
        cw, ct = old_w, old_t
    else:
        raise ValueError(f"{name!r} is not a model-kind fault")
    return (torch.where(byz[:, None], cw, w), torch.where(byz, ct, t))


def bitflip_payload(byz, key, payload, rows=None,
                    n_total: Optional[int] = None):
    """Flip one uniformly drawn bit in each Byzantine row of an encoded
    (m, P) payload of any codec's dtype.

    The reference draws ``u = uniform(key, (m, 1))`` (or the rows ``rows``
    of the ``(n_total, 1)`` draw), takes bit ``min(trunc(u * nbits), nbits
    - 1)`` of the row's ``nbits = P * itemsize * 8`` (``u * nbits`` rounded
    in float32) and XORs it into the row's lanes viewed as unsigned
    integers. Lane ``b // (8 itemsize)``, bit ``b % (8 itemsize)`` of a
    little-endian lane is bit ``b % 8`` of the row's byte ``b // 8``, so the
    flip is made on the row's bytes (``Tensor.view(torch.uint8)``, where
    XOR exists for every codec's dtype)."""
    m = payload.shape[0]
    raw = payload.contiguous().view(torch.uint8)          # (m, P * itemsize)
    nbits = raw.shape[1] * 8
    u = _uniform_rows(key, m, 1, rows, n_total)[:, 0]
    bit = torch.clamp_max((u * nbits).to(torch.int64), nbits - 1)
    lane = torch.arange(raw.shape[1], device=raw.device)[None, :]
    mask = torch.bitwise_left_shift(torch.ones_like(bit), bit % 8)
    flip = torch.where(lane == (bit // 8)[:, None], mask[:, None],
                       0).to(torch.uint8)
    flipped = torch.bitwise_xor(raw, flip).view(payload.dtype)
    return torch.where(byz[:, None], flipped, payload)


def _ftz(x):
    """``x`` with its subnormal values flushed to a zero of their sign."""
    return torch.where(torch.abs(x) < _FLT_MIN, x * 0.0, x)


# XLA's order for the screen's row sums, by the row's width d
FUSED_SUM_MAX_WIDTH = 32          # fused multiply-adds at d <= 32 ...
UNFUSED_WIDTHS = range(5, 9)      # ... but on vectorised rows at these
HALVES_MAX_WIDTH = 64             # two halves at 33 <= d <= 64
SUM_CHUNK = 32                    # 32-wide chunks at multiples of 32

# Which rows of a screen sum XLA's vector loop takes at 5 <= d <= 8
# (measured on jax.jit of the sums and of apply_receives, jax 0.9.0, on an
# 8-CPU x86 host). XLA on the CPU splits the fusion's rows into P
# workgroups, P = min(ceil(sqrt(CPUs)), max(1, bytes // 256 KiB)), bytes
# = 4 N (factors d + 1) for a sum reading `factors` (N, d) arrays, each
# ceil(N / P) rows but the last; LLVM vectorises each workgroup's loop 4
# rows wide, twice interleaved (an 8-row step) from the trip count below
# (never for a two-array sum at d = 7, 8), and the rows past the last full
# step take the scalar loop, which fuses. A loop under 16 rows is scalar
# but at 4 and 8 rows (and at 2 for the squares at d >= 6), and at P = 2
# with N odd every row is (XLA guards each row of the uneven split).
_WORKGROUP_BYTES = 256 << 10
_INTERLEAVED_FROM = {(5, 1): 32, (6, 1): 32, (5, 2): 48, (6, 2): 48,
                     (7, 1): 88, (8, 1): 80}


def _fma(a, b, c):
    """float32 ``fma(a, b, c)``, correctly rounded (PyTorch has no fused
    multiply-add). The float64 product of two float32 values is exact, so
    only the add rounds: the float64 sum, rounded to odd with its TwoSum
    error term, then cast to float32, rounds once, as the fused operation
    does (a float64 add and a cast alone would round twice)."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)             # s + err == p + c exactly
    bits = s.view(torch.int64)
    odd = torch.where((err > 0) == (s > 0), bits + 1, bits - 1)
    inexact = (err != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    return torch.where(inexact, odd, bits).view(torch.float64).to(a.dtype)


def _in_sequence(terms):
    """The (..., d) terms' row sums added in sequence from +0.0, j = 0 ...
    d - 1, each partial sum flushed as XLA's arithmetic flushes it."""
    total = torch.zeros(terms.shape[:-1], dtype=terms.dtype,
                        device=terms.device)
    for j in range(terms.shape[-1]):
        total = _ftz(total + terms[..., j])
    return total


def xla_workgroups(n: int, d: int, factors: int) -> int:
    """The workgroups XLA on this host splits a sum of N rows of
    ``factors`` (N, d) arrays into (the note above ``_WORKGROUP_BYTES``)."""
    most = math.ceil(math.sqrt(len(os.sched_getaffinity(0))))
    return max(1, min(most, 4 * n * (factors * d + 1) // _WORKGROUP_BYTES))


def _vector_rows(rows: int, d: int, factors: int) -> int:
    """How many of a workgroup's first rows XLA's vector loop takes."""
    if rows < 16:
        return rows if rows in (4, 8) or (rows == 2 and factors == 1
                                          and d >= 6) else 0
    step = 8 if rows >= _INTERLEAVED_FROM.get((d, factors), rows + 1) else 4
    return rows // step * step


def screen_split(n: int, d: int, factors: int):
    """Which rows of a screen sum at 5 <= d <= 8 over N rows of ``factors``
    arrays XLA sums unfused, as (rows a workgroup, vector rows of every
    workgroup but the last, vector rows of the last): row i lies in
    workgroup q = i // rows, and is summed unfused where i - q rows is
    below its workgroup's vector rows. The receive kernel takes the same
    three numbers."""
    p = xla_workgroups(n, d, factors)
    if p == 2 and n % 2:
        return n, 0, 0
    rows = max(1, -(-n // p))
    last = n - (-(-n // rows) - 1) * rows
    return rows, _vector_rows(rows, d, factors), _vector_rows(last, d,
                                                              factors)


def _unfused_rows(n: int, d: int, factors: int, device):
    """(N,) bool: the rows ``screen_split`` sums unfused."""
    rows, full, last = screen_split(n, d, factors)
    i = torch.arange(n, device=device)
    q = i // rows
    vector = torch.where(q == (n - 1) // rows, last, full)
    return i - q * rows < vector


def screen_order_known(d: int) -> bool:
    """Whether ``_screen_sum`` takes the jitted reference's order at width
    d (every d up to 64 and the multiples of 32), so that the screen's
    rescale equals the reference's bit for bit."""
    return d <= HALVES_MAX_WIDTH or d % SUM_CHUNK == 0


def _fused_sum(a, b):
    """The row sums of ``a * b`` by fused multiply-adds in sequence from
    +0.0, each result flushed."""
    total = torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
    for j in range(a.shape[-1]):
        total = _ftz(_fma(a[..., j], b[..., j], total))
    return total


def _screen_sum(a, b, factors=None):
    """The row sums of ``a * b`` over the (..., N, d) factors ``a`` and
    ``b`` (flushed), in the order of the jitted reference (the module
    note), whose sum reads ``factors`` arrays (1 where ``a is b``, else 2
    by default). At d = 1 the one product as it is (a -0.0 stays -0.0);
    at 2 <= d <= 32 fused multiply-adds in sequence from +0.0, each result
    flushed, but at d = 5 ... 8 on the rows ``screen_split`` names, where
    the products round apart and add in sequence; at 33 <= d <= 64 the
    rounded products in two halves, j < ceil(d/2) and the rest, each in
    sequence, then added; at multiples of 32 above 64 32-wide chunks in
    sequence, then the chunk sums in sequence; at every other d
    ``torch.sum`` (XLA's order is not known there)."""
    d = a.shape[-1]
    if d == 1:
        return _ftz(a[..., 0] * b[..., 0])
    if d <= FUSED_SUM_MAX_WIDTH and d not in UNFUSED_WIDTHS:
        return _fused_sum(a, b)
    terms = _ftz(a * b)
    if d <= FUSED_SUM_MAX_WIDTH:
        factors = factors or (1 if a is b else 2)
        unfused = _unfused_rows(a.shape[-2], d, factors, a.device)
        return torch.where(unfused, _in_sequence(terms), _fused_sum(a, b))
    if d <= HALVES_MAX_WIDTH:
        h = (d + 1) // 2
        return _ftz(_in_sequence(terms[..., :h])
                    + _in_sequence(terms[..., h:]))
    if d % SUM_CHUNK == 0:
        return _in_sequence(_in_sequence(
            terms.unflatten(-1, (d // SUM_CHUNK, SUM_CHUNK))))
    return torch.sum(terms, dim=-1)


def _sqrt(x):
    """The correctly rounded float32 square root, as XLA and CUDA's sqrtf
    give it: ``torch.sqrt`` on the CPU is off by one ulp on some inputs
    (29 of 4000 random quotients), while the float64 root rounded once to
    float32 is exact on every device."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def apply_defense(defense: str, msg_w, valid, recv_w):
    """Screen one receive round's payloads against the receiver's state.

    ``msg_w`` (m, d) decoded f32 payloads, ``valid`` (m,) bool, ``recv_w``
    (m, d) the receiver's current lastModel. Returns ``(msg_w, valid,
    gated, clipped)``: the payloads (rescaled where clipped), the surviving
    valid mask, and per-node bools of a rejected and of a rescaled message.
    The port pads no lanes, so the reference's ``real=`` mask has no
    counterpart here. Subnormals are flushed as the module note says."""
    if defense == "none":
        zeros = torch.zeros_like(valid)
        return msg_w, valid, zeros, zeros
    m, r = _ftz(msg_w), _ftz(recv_w)
    squares = torch.stack((m, r))
    sq, rn = _screen_sum(squares, squares)       # each reads one array
    if defense == "cosine_gate":
        dot = _screen_sum(m, r)                  # reads two
    finite = torch.isfinite(sq)            # NaN/inf anywhere poisons the sum
    if defense == "norm_clip":
        thr = torch.clamp_min(NORM_CLIP_MULT_SQ * rn, NORM_CLIP_FLOOR_SQ)
        clip = finite & (sq > thr)
        scale = _sqrt(_ftz(thr / torch.clamp_min(sq, CLIP_SQ_GUARD)))
        msg_w = torch.where(clip[:, None], _ftz(m * scale[:, None]), msg_w)
        return msg_w, valid & finite, valid & ~finite, valid & clip
    if defense == "cosine_gate":
        anti = (rn > COSINE_GATE_MIN_NORM_SQ) & (
            dot < COSINE_GATE_THRESHOLD_F32 * _sqrt(_ftz(sq * rn)))
        reject = ~finite | anti
        return (msg_w, valid & ~reject, valid & reject,
                torch.zeros_like(valid))
    raise ValueError(f"unknown defense {defense!r} "
                     f"(expected one of {list(DEFENSES)})")
