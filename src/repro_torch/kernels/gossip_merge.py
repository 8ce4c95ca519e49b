"""The fused MERGE + Pegasos step, CREATEMODELMU's hot path, as one kernel.

Counterpart of ``repro/kernels/gossip_merge.py`` (the Pallas TPU kernel
``merge_update``): ``w = (w1 + w2) / 2``, ``t = max(t1, t2)``, then the
Pegasos step of ``pegasos_update``, in one pass that reads the two models
and the example once and writes the new model once.

``merge_update`` dispatches on the tensors' device: CUDA tensors go to the
hand-written kernel in ``csrc/pegasos_merge.cu`` (kernel #6 with its merge
prologue switched on by a template flag), CPU tensors to the plain version
``ref.merge_update_ref``. There is no fallback.
"""
from __future__ import annotations

from repro_torch.kernels.pegasos_update import check_rows, launch_rows
from repro_torch.kernels.ref import merge_update_ref


def merge_update(w1, t1, w2, t2, x, y, *, lam: float):
    """update(merge((w1, t1), (w2, t2))) with the local example (x, y):
    w1, w2, x (N, d) f32; t1, t2 (N,) int32; y (N,) ±1 f32. Returns the new
    (w, t) in new tensors. Every tensor must be contiguous and on one
    device."""
    n, d = check_rows({"w1": (w1, t1), "w2": (w2, t2)}, x, y)
    if w1.device.type == "cpu":
        return merge_update_ref(w1, t1, w2, t2, x, y, lam)
    out = launch_rows("merge_update", (w1, t1, w2, t2, x, y), n, d, lam,
                      w1.device)
    _MERGE.launches += 1
    return out


# Kernel launches so far; only the CUDA path counts.
merge_update.launches = 0
_MERGE = merge_update
