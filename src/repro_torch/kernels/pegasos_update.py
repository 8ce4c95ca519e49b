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

The source has two layouts for each kernel, chosen by ``row_route``
before the launch: ``"tiled"`` (persistent blocks walking tiles of rows
through shared memory) on 16-byte aligned operands up to a width of each
kernel's own (this kernel, #6, at d <= ``STEP_TILED_MAX_WIDTH``; the merge,
#7 in ``gossip_merge.py``, at d <= ``MERGE_TILED_MAX_WIDTH``),
``"strided"`` (a warp a row, a block a row at d >= 1024) for the rest.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gossip_cycle import (_FLOAT, _INT, _VP,
                                              _check_tensors, _entry,
                                              _raise_on, _stream, refuse_grad)
from repro_torch.kernels.ref import pegasos_update_ref


# the row kernels' layouts (their codes in the C entries), the widest d
# the rule sends the step and the merge to the tiled layout (of the widths
# chip_smoke.py times both layouts at, 10, 32, 57 and 128, the widest where
# tiled is the faster on an H100), and the widest d the tiled kernel takes
ROW_ROUTES = ("tiled", "strided")
STEP_TILED_MAX_WIDTH = 57
MERGE_TILED_MAX_WIDTH = 57
TILED_KERNEL_MAX_WIDTH = 128
# a tile: the (N, d) and (N,) arrays of a row in a 16 KB slot, a multiple
# of 16 rows, 16 to 256 (csrc/pegasos_merge.cu::tile_rows_at)
_SLOT_BYTES = 16384
_TILED_MAX_ROWS = 256


def _tile_rows(d: int, arrays: int) -> int:
    r = _SLOT_BYTES // (4 * arrays * (d + 1)) // 16 * 16
    return max(16, min(_TILED_MAX_ROWS, r))


def step_tile_rows(d: int) -> int:
    """Rows a tile of the tiled step holds at width d: as many as a 16 KB
    slot holds of w, x, t and y, rounded down to a multiple of 16, at
    least 16 and at most 256."""
    return _tile_rows(d, 2)


def merge_tile_rows(d: int) -> int:
    """Rows a tile of the tiled merge holds at width d: as many as a 16 KB
    slot holds of w1, w2, x, t1, t2 and y, rounded down to a multiple of
    16, at least 16 and at most 256."""
    return _tile_rows(d, 3)


def row_route(d: int, merge: bool, aligned: bool = True) -> str:
    """Which layout of ``csrc/pegasos_merge.cu`` serves d coefficients on
    CUDA: ``"tiled"`` at d <= ``STEP_TILED_MAX_WIDTH`` for the step and
    d <= ``MERGE_TILED_MAX_WIDTH`` for the merge (``merge``) when every
    operand starts on a 16-byte boundary (``aligned``; the tiles are copied
    16 bytes at a time), else ``"strided"``: wider rows (Reuters' d = 9947
    a block a row) and unaligned operands."""
    limit = MERGE_TILED_MAX_WIDTH if merge else STEP_TILED_MAX_WIDTH
    return "tiled" if d <= limit and aligned else "strided"


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


def launch_rows(wrapper, tensors, n: int, d: int, lam: float, route=None):
    """Launch kernel #6 (``wrapper`` ``pegasos_update``, ``tensors`` (w, t,
    x, y)) or #7 (``merge_update``, (w1, t1, w2, t2, x, y)) of
    ``csrc/pegasos_merge.cu`` on checked operands, on the layout ``route``
    (``row_route``'s where None; a forced ``"tiled"`` is refused past
    d = 128 and on unaligned operands), and count the launch on
    ``wrapper``. Returns the new (w, t)."""
    entry = wrapper.__name__
    aligned = all(a.data_ptr() % 16 == 0 for a in tensors)
    if route is None:
        route = row_route(d, entry == "merge_update", aligned)
    elif route not in ROW_ROUTES or (route == "tiled" and (
            d > TILED_KERNEL_MAX_WIDTH or not aligned)):
        raise ValueError(f"the {route!r} layout of {entry} does not take "
                         f"d={d}" + ("" if aligned else
                                     " on unaligned operands"))
    fn, err = _entry("pegasos_merge", entry,
                     (_VP,) * (len(tensors) + 2) + (_INT, _INT, _FLOAT, _INT,
                                                    _VP))
    device = tensors[0].device
    w_out = torch.empty((n, d), dtype=torch.float32, device=device)
    t_out = torch.empty(n, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        code = fn(*(a.data_ptr() for a in tensors), w_out.data_ptr(),
                  t_out.data_ptr(), n, d, float(lam),
                  ROW_ROUTES.index(route), _stream(w_out))
    _raise_on(code, err, f"{entry} ({route})")
    wrapper.launches += 1
    wrapper.route_launches[route] += 1
    return w_out, t_out


def pegasos_update(w, t, x, y, *, lam: float):
    """w, x: (N, d) f32; t: (N,) int32; y: (N,) ±1 f32. Returns the new
    (w', t') in new tensors. Every tensor must be contiguous and on one
    device."""
    n, d = check_rows({"w": (w, t)}, x, y)
    if w.device.type == "cpu":
        return pegasos_update_ref(w, t, x, y, lam)
    refuse_grad("pegasos_update", w, x, y)
    return _launch_step((w, t, x, y), n, d, lam)


def _launch_step(tensors, n: int, d: int, lam: float, route=None):
    """Launch the step on checked operands (w, t, x, y). ``route``
    overrides ``row_route`` (for holding the two layouts to each other and
    timing them on the card); the public wrapper never passes it."""
    return launch_rows(_PEGASOS, tensors, n, d, lam, route)


# Kernel launches so far, in all and by layout; only the CUDA path counts.
# Bound to the wrapper object itself, so the counts survive a caller
# wrapping the module attribute.
pegasos_update.launches = 0
pegasos_update.route_launches = dict.fromkeys(ROW_ROUTES, 0)
_PEGASOS = pegasos_update
