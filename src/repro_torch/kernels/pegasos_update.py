"""The population Pegasos step (Algorithm 3, lines 1-10) as one kernel.

Counterpart of ``repro/kernels/pegasos_update.py`` (the Pallas TPU kernel
``pegasos_update``): for every row, ``t' = t + 1``, ``eta = 1/(lam t')``
and ``w' = (1 - eta lam) w + [y <w, x> < 1] (eta y) x``, the margin, the
hinge, the decay and the axpy in one pass over the (N, d) rows.

``pegasos_update`` dispatches on the tensors' device: CUDA tensors go to
the hand-written kernel in ``csrc/pegasos_merge.cu`` (built by ``nvcc``
for sm_90a at first use), CPU tensors to the plain version
``ref.pegasos_update_ref``, which follows the kernel's op order. There is
no fallback: a CUDA tensor reaches the kernel or an exception. The kernel
takes the rows as they are: the TPU kernel's padding of d to 128 lanes and
of N to its 8-row blocks is a TPU tiling rule and has no counterpart.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gossip_cycle import (_FLOAT, _INT, _VP,
                                              _check_tensors, _entry,
                                              _raise_on, _stream)
from repro_torch.kernels.ref import pegasos_update_ref


def check_rows(models, x, y):
    """Validate the operands of kernels #6 and #7: ``models`` maps each
    (N, d) f32 model's name to (w, t) with t (N,) int32; x (N, d) f32, y
    (N,) f32, all contiguous and on one device. Returns (N, d)."""
    w0 = next(iter(models.values()))[0]
    if w0.ndim != 2:
        raise ValueError("expected (N, d) models")
    n, d = w0.shape
    spec = {"x": (x, torch.float32, (n, d)), "y": (y, torch.float32, (n,))}
    for name, (w, t) in models.items():
        spec[name] = (w, torch.float32, (n, d))
        spec[f"t of {name}"] = (t, torch.int32, (n,))
    _check_tensors(w0, spec)
    if w0.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no Pegasos kernel for device "
                                  f"{w0.device}")
    return n, d


def launch_rows(entry: str, tensors, n: int, d: int, lam: float, device):
    """Launch ``entry`` of ``csrc/pegasos_merge.cu`` on ``tensors`` (its
    input pointers in order); returns the new (w, t)."""
    fn, err = _entry("pegasos_merge", entry,
                     (_VP,) * (len(tensors) + 2) + (_INT, _INT, _FLOAT, _VP))
    w_out = torch.empty((n, d), dtype=torch.float32, device=device)
    t_out = torch.empty(n, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        code = fn(*(a.data_ptr() for a in tensors), w_out.data_ptr(),
                  t_out.data_ptr(), n, d, float(lam), _stream(w_out))
    _raise_on(code, err, entry)
    return w_out, t_out


def pegasos_update(w, t, x, y, *, lam: float):
    """w, x: (N, d) f32; t: (N,) int32; y: (N,) ±1 f32. Returns the new
    (w', t') in new tensors. Every tensor must be contiguous and on one
    device."""
    n, d = check_rows({"w": (w, t)}, x, y)
    if w.device.type == "cpu":
        return pegasos_update_ref(w, t, x, y, lam)
    out = launch_rows("pegasos_update", (w, t, x, y), n, d, lam, w.device)
    _PEGASOS.launches += 1
    return out


# Kernel launches so far; only the CUDA path counts. Bound to the wrapper
# object itself, so the count survives a caller wrapping the module
# attribute.
pegasos_update.launches = 0
_PEGASOS = pegasos_update
