"""Online learners (Algorithm 3): Pegasos, Adaline, logistic regression.

Counterpart of ``repro/core/learners.py``, with the same op order. A linear
model is the pair ``(w, t)``; ``w`` may be ``(d,)`` or ``(N, d)`` with a
matching ``t``, and every rule is written point-wise over the population.
Labels are in {-1, +1}.

``make_update(..., fused=True)`` gives the (N, d) steps of Adaline and
logistic regression, the learners the sharded engine's vector apply runs,
in the order XLA runs them on the CPU under ``jax.jit``, as the
reference's sharded engine runs its vector apply (measured with jax 0.9.0
by ``tools/measure_step_fusion.py``, which also holds Pegasos' rule: the
engine applies Pegasos with the receive kernel, in the Pallas kernel's
order): LLVM contracts every product that feeds one add into a fused
multiply-add, so

* Adaline: ``w' = fma(eta * err, x, w)``;
* logistic: ``w' = fma(1 - eta lam, w, -((eta g) x))``, and the sigmoid is
  XLA's ``1 / (exp(-z) + 1)`` with its Cephes ``exp`` (``xla_sigmoid``),
  its result flushed as XLA flushes subnormals;

and every dot product ``<w, x>`` is summed as the screen's sums are
(``faults._screen_sum``: fused multiply-adds in sequence at d <= 32, the
split at 5 <= d <= 8, two halves at 33-64). With these rules the vector
apply equals the jitted reference's bit for bit under ``rw`` without
norm_clip (the eager order in no case). Where a product of the merge
(``(w1 + w2) / 2``, under ``mu`` and ``um``) or of norm_clip's rescale
meets the step, XLA fuses one of them into the step's add, and which one
depends on the shape of the fusion (LLVM unswitches the loop on the clip
flag and sinks the last coefficient's add past the branch): no rule was
found, and those results stay within the float tolerance that
``tests/test_torch_vector_apply.py`` states.
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import torch

from repro_torch.core import faults
from repro_torch.utils.device import resolve_device


class LinearModel(NamedTuple):
    """The message payload of gossip learning: one linear model."""

    w: torch.Tensor          # (d,) or (N, d) float32
    t: torch.Tensor          # () or (N,) int32 update counter


def init_model(d: int, n: int | None = None, device=None) -> LinearModel:
    """INITMODEL (Algorithm 3): w = 0 (float32), t = 0 (int32); one (d,)
    model, or a population of ``n`` when given, on ``device`` (the CUDA
    card unless named)."""
    dev = resolve_device(device)
    shape = (d,) if n is None else (n, d)
    return LinearModel(torch.zeros(shape, dtype=torch.float32, device=dev),
                       torch.zeros(shape[:-1], dtype=torch.int32,
                                   device=dev))


def pegasos_update(m: LinearModel, x, y, lam: float) -> LinearModel:
    """UPDATEPEGASOS (Algorithm 3, lines 1–10): t <- t+1; eta = 1/(lam*t);
    w <- (1 - eta*lam) w + [margin < 1] eta*y*x."""
    t = m.t + 1
    eta = 1.0 / (lam * t.to(torch.float32))
    margin = y * torch.sum(m.w * x, dim=-1)
    decay = 1.0 - eta * lam
    if m.w.ndim == 2:
        decay = decay[:, None]
        eta = eta[:, None]
        hinge = (margin < 1.0)[:, None]
        yx = y[:, None] * x if torch.is_tensor(y) and y.ndim else y * x
    else:
        hinge = margin < 1.0
        yx = y * x
    w = decay * m.w + torch.where(hinge, eta * yx, 0.0)
    return LinearModel(w, t)


def adaline_update(m: LinearModel, x, y, eta: float) -> LinearModel:
    """UPDATEADALINE (Algorithm 3, lines 12–15): w += eta (y - <w,x>) x."""
    err = y - torch.sum(m.w * x, dim=-1)
    if m.w.ndim == 2:
        err = err[:, None]
    return LinearModel(m.w + eta * err * x, m.t + 1)


def logistic_update(m: LinearModel, x, y, eta: float,
                    lam: float = 0.0) -> LinearModel:
    """Logistic-loss SGD with L2 decay."""
    t = m.t + 1
    z = y * torch.sum(m.w * x, dim=-1)
    g = -y * torch.sigmoid(-z)
    if m.w.ndim == 2:
        g = g[:, None]
    w = (1.0 - eta * lam) * m.w - eta * g * x
    return LinearModel(w, t)


def _f32(hex64: str) -> float:
    """A float32 constant of XLA's IR, given as the IR writes it (the
    double's 16 hex digits)."""
    return struct.unpack(">d", bytes.fromhex(hex64))[0]


# XLA's CPU exp (Cephes): the input's clamp, log2(e), ln 2 in two parts
# and the polynomial, as its IR holds them
_EXP_LO, _EXP_HI = _f32("C055F33340000000"), _f32("4056333340000000")
_LOG2E = _f32("3FF7154760000000")
_LN2_HI, _LN2_LO = _f32("3FE6300000000000"), _f32("BF2BD01060000000")
_EXP_POLY = (_f32("3F2A0D2CE0000000"), _f32("3F56E879C0000000"),
             _f32("3F81112100000000"), _f32("3FA5553820000000"),
             _f32("3FC5555540000000"), 0.5)


def _exp_parts(x):
    """XLA's float32 ``exp(x)`` on the CPU as the pair ``(p, 2^n)``, whose
    product is the result: n = floor(x log2 e + 1/2) clamped to +-127, the
    remainder r = x - n ln 2 in two fused steps, and p = 1 + r + r^2 P(r)
    by fused multiply-adds (products that feed one add fuse)."""
    full = lambda v: torch.full_like(x, v)
    x = torch.clamp(torch.clamp(x, min=_EXP_LO), max=_EXP_HI)
    n = torch.floor(faults._fma(x, full(_LOG2E), full(0.5)))
    n = torch.clamp(torch.clamp(n, min=-127.0), max=127.0)
    r = faults._fma(full(-_LN2_HI), n, x)
    r = faults._fma(full(-_LN2_LO), n, r)
    p = faults._fma(r, full(_EXP_POLY[0]), full(_EXP_POLY[1]))
    for c in _EXP_POLY[2:]:
        p = faults._fma(p, r, full(c))
    p = faults._fma(p, r * r, r) + 1.0
    return p, ((n.to(torch.int32) + 127) << 23).view(torch.float32)


def xla_sigmoid(x):
    """``jax.nn.sigmoid`` of float32 ``x`` under ``jax.jit`` on the CPU,
    bit for bit: ``1 / (exp(-x) + 1)``, the scaling by 2^n fused into the
    add, the quotient flushed."""
    p, scale = _exp_parts(-x)
    return faults._ftz(1.0 / faults._fma(p, scale, torch.ones_like(p)))


def _dot(w, x):
    """``sum(w * x, axis=-1)`` of (..., N, d) rows in the jitted order."""
    return faults._screen_sum(w, x, 2)


def adaline_update_fused(m: LinearModel, x, y, eta: float) -> LinearModel:
    """:func:`adaline_update` of (N, d) models in the jitted order."""
    err = y - _dot(m.w, x)
    return LinearModel(faults._fma((eta * err)[..., None].expand_as(m.w),
                                   x, m.w), m.t + 1)


def logistic_update_fused(m: LinearModel, x, y, eta: float,
                          lam: float = 0.0) -> LinearModel:
    """:func:`logistic_update` of (N, d) models in the jitted order."""
    g = -y * xla_sigmoid(-(y * _dot(m.w, x)))
    return LinearModel(faults._fma(torch.full_like(m.w, 1.0 - eta * lam),
                                   m.w, -((eta * g)[..., None] * x)),
                       m.t + 1)


def make_update(learner: str, *, lam: float = 1e-4, eta: float = 0.01,
                fused: bool = False):
    """The learner's step ``update(m, x, y)``; ``fused`` takes the jitted
    order of (N, d) steps, for Adaline and logistic regression (the module
    note)."""
    if fused:
        if learner == "adaline":
            return lambda m, x, y: adaline_update_fused(m, x, y, eta)
        if learner == "logistic":
            return lambda m, x, y: logistic_update_fused(m, x, y, eta, lam)
        raise ValueError(f"no step in the jitted order for learner "
                         f"{learner!r} (the vector apply runs adaline and "
                         "logistic)")
    if learner == "pegasos":
        return lambda m, x, y: pegasos_update(m, x, y, lam)
    if learner == "adaline":
        return lambda m, x, y: adaline_update(m, x, y, eta)
    if learner == "logistic":
        return lambda m, x, y: logistic_update(m, x, y, eta, lam)
    raise ValueError(f"unknown learner {learner!r}")


def predict(w, x):
    """PREDICT (Algorithm 4): sign of the inner product."""
    return torch.sign(torch.sum(w * x, dim=-1))
