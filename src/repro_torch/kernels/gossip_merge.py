"""The fused MERGE + Pegasos step, CREATEMODELMU's hot path, as one kernel.

Counterpart of ``repro/kernels/gossip_merge.py`` (the Pallas TPU kernel
``merge_update``): ``w = (w1 + w2) / 2``, ``t = max(t1, t2)``, then the
Pegasos step of ``pegasos_update``, in one pass that reads the two models
and the example once and writes the new model once.

``merge_update`` dispatches on the tensors' device: CUDA tensors go to the
hand-written kernels in ``csrc/pegasos_merge.cu``, on the layout
``pegasos_update.row_route`` picks (``"tiled"``, persistent blocks walking
tiles of rows through shared memory, at d <= 57 on aligned operands;
``"strided"``, a warp a row, for the rest; each is kernel #6's layout with
its merge prologue switched on by a template flag), CPU tensors to the
plain version
``ref.merge_update_ref``. There is no fallback.
"""
from __future__ import annotations

from repro_torch.kernels.gossip_cycle import refuse_grad
from repro_torch.kernels.pegasos_update import (ROW_ROUTES, check_rows,
                                                launch_rows)
from repro_torch.kernels.ref import merge_update_ref


def merge_update(w1, t1, w2, t2, x, y, *, lam: float):
    """update(merge((w1, t1), (w2, t2))) with the local example (x, y):
    w1, w2, x (N, d) f32; t1, t2 (N,) int32; y (N,) ±1 f32. Returns the new
    (w, t) in new tensors. Every tensor must be contiguous and on one
    device."""
    n, d = check_rows({"w1": (w1, t1), "w2": (w2, t2)}, x, y)
    if w1.device.type == "cpu":
        return merge_update_ref(w1, t1, w2, t2, x, y, lam)
    refuse_grad("merge_update", w1, w2, x, y)
    return _launch_merge((w1, t1, w2, t2, x, y), n, d, lam)


def _launch_merge(tensors, n: int, d: int, lam: float, route=None):
    """Launch the merge on checked operands (w1, t1, w2, t2, x, y).
    ``route`` overrides ``row_route`` (for holding the two layouts to each
    other and timing them on the card): ``"tiled"`` is refused past
    d = 128 and on unaligned operands; the public wrapper never passes
    it."""
    return launch_rows(_MERGE, tensors, n, d, lam, route)


# Kernel launches so far, in all and by layout; only the CUDA path counts.
merge_update.launches = 0
merge_update.route_launches = dict.fromkeys(ROW_ROUTES, 0)
_MERGE = merge_update
