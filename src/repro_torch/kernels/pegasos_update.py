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

The source has two layouts, chosen by ``row_route`` before the launch:
``"tiled"`` (persistent blocks walking tiles of rows through shared
memory) for the merge (kernel #7, ``gossip_merge.py``) at d <= 57 on
16-byte aligned operands, ``"strided"`` (a warp a row, a block a row at
d >= 1024) for the rest, the step alone (this kernel, #6) included.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gossip_cycle import (_FLOAT, _INT, _VP,
                                              _check_tensors, _entry,
                                              _raise_on, _stream)
from repro_torch.kernels.ref import pegasos_update_ref


# the row kernels' layouts (their codes in the merge's C entry), the widest
# d the rule sends the merge to the tiled layout (of the widths
# chip_smoke.py times both layouts at, 10, 32, 57 and 128, the widest where
# tiled is the faster on an H100), and the widest d its kernel takes
ROW_ROUTES = ("tiled", "strided")
MERGE_TILED_MAX_WIDTH = 57
MERGE_TILED_KERNEL_MAX_WIDTH = 128
# a tile of the tiled merge: w1, w2 and x (d floats each) and t1, t2 and y
# a row in a 16 KB slot, a multiple of 16 rows, 16 to 256
# (csrc/pegasos_merge.cu::merge_rows)
_MERGE_SLOT_BYTES = 16384
_TILED_MAX_ROWS = 256


def merge_tile_rows(d: int) -> int:
    """Rows a tile of the tiled merge holds at width d: as many as a 16 KB
    slot holds of w1, w2, x, t1, t2 and y, rounded down to a multiple of
    16, at least 16 and at most 256."""
    r = _MERGE_SLOT_BYTES // (4 * (3 * d + 3)) // 16 * 16
    return max(16, min(_TILED_MAX_ROWS, r))


def row_route(d: int, merge: bool, aligned: bool = True) -> str:
    """Which layout of ``csrc/pegasos_merge.cu`` serves d coefficients on
    CUDA: ``"tiled"`` for the merge (``merge``) at d <= 57 when every
    operand starts on a 16-byte boundary (``aligned``; the tiles are copied
    16 bytes at a time), else ``"strided"``: the step alone, wider rows
    (Reuters' d = 9947 a block a row) and unaligned operands."""
    if merge and d <= MERGE_TILED_MAX_WIDTH and aligned:
        return "tiled"
    return "strided"


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


def launch_rows(entry: str, tensors, n: int, d: int, lam: float, device,
                route=None):
    """Launch ``entry`` of ``csrc/pegasos_merge.cu`` on ``tensors`` (its
    input pointers in order), with the layout ``route`` where the entry
    takes one (the merge's); returns the new (w, t)."""
    routed = () if route is None else (_INT,)
    fn, err = _entry("pegasos_merge", entry,
                     (_VP,) * (len(tensors) + 2) + (_INT, _INT, _FLOAT)
                     + routed + (_VP,))
    w_out = torch.empty((n, d), dtype=torch.float32, device=device)
    t_out = torch.empty(n, dtype=torch.int32, device=device)
    code_of = () if route is None else (ROW_ROUTES.index(route),)
    with torch.cuda.device(device):
        code = fn(*(a.data_ptr() for a in tensors), w_out.data_ptr(),
                  t_out.data_ptr(), n, d, float(lam), *code_of,
                  _stream(w_out))
    _raise_on(code, err, entry if route is None else f"{entry} ({route})")
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
    _PEGASOS.route_launches[row_route(d, merge=False)] += 1
    return out


# Kernel launches so far, in all and by layout; only the CUDA path counts.
# Bound to the wrapper object itself, so the counts survive a caller
# wrapping the module attribute.
pegasos_update.launches = 0
pegasos_update.route_launches = dict.fromkeys(ROW_ROUTES, 0)
_PEGASOS = pegasos_update
