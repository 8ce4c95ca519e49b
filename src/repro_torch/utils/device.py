"""The port's device rule: CUDA unless the caller names another device."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device=None`` means the CUDA card, and raises without one — the
    port never falls back to the CPU on its own. Pass ``device="cpu"`` to
    run on the CPU (the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
