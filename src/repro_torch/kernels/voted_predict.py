"""Batched VOTEDPREDICT: the serving tier's kernel.

Counterpart of ``repro/kernels/voted_predict.py`` (the Pallas TPU kernel
``voted_predict_batched``). For each of M queries, answered by one node:
the C scores ``<w_c, x>`` of the node's cache ring, a vote ``score >= 0``
over the slots below the node's ``count``, ``p_ratio = pos / max(count,
1)``, and the answer +1 where ``p_ratio - 0.5 >= 0``, else -1.

``voted_predict_batched`` dispatches on the tensors' device: CUDA tensors
go to the hand-written kernel in ``csrc/voted_predict.cu`` (built by
``nvcc`` for sm_90a at first use), CPU tensors to
``voted_predict_batched_plain`` beside it. The kernel reads the rows
``w[assign[m]]`` of the whole (N, C, d) snapshot itself, where the TPU
kernel is given the gathered (M, C, d) rows: the same function without the
gathered copy, which is the case ``assign = arange(M)``. There is no
fallback: a CUDA tensor reaches the kernel or an exception.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gossip_cycle import (_VP, _INT, _check_tensors,
                                              _entry, _raise_on, _stream)


def voted_predict_batched_plain(w, count, X):
    """The vote in plain PyTorch on gathered rows, in ``serving.
    serve_voted``'s op order: w (M, C, d) f32, count (M,) int32, X (M, d)
    f32 -> (M,) ±1 f32."""
    c = w.shape[1]
    scores = torch.einsum("mcd,md->mc", w, X)
    votes = (scores >= 0).to(torch.float32)
    valid = (torch.arange(c, device=w.device)[None, :]
             < count[:, None]).to(torch.float32)
    p_ratio = (torch.einsum("mc,mc->m", votes, valid)
               / torch.clamp_min(count, 1).to(torch.float32))
    return torch.where(p_ratio - 0.5 >= 0, 1.0, -1.0)


def _launch(w, count, X, assign):
    fn, err = _entry("voted_predict", "voted_predict_batched",
                     (_VP,) * 5 + (_INT,) * 3 + (_VP,))
    _, c, d = w.shape
    m = X.shape[0]
    out = torch.empty(m, dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        code = fn(w.data_ptr(), count.data_ptr(), X.data_ptr(),
                  assign.data_ptr(), out.data_ptr(), m, c, d, _stream(w))
    _raise_on(code, err, "voted_predict")
    _VOTED.launches += 1
    return out


def voted_predict_batched(w, count, X, assign):
    """VOTEDPREDICT for M queries: w (N, C, d) f32 and count (N,) int32 are
    the whole snapshot, X (M, d) f32 the queries, and query m is answered
    by node ``assign[m]`` ((M,) int32). Returns (M,) ±1 f32. Every tensor
    must be contiguous and on one device."""
    if w.ndim != 3 or X.ndim != 2:
        raise ValueError("expected w (N, C, d) and X (M, d)")
    n, c, d = w.shape
    m = X.shape[0]
    _check_tensors(w, {"w": (w, torch.float32, (n, c, d)),
                       "count": (count, torch.int32, (n,)),
                       "X": (X, torch.float32, (m, d)),
                       "assign": (assign, torch.int32, (m,))})
    if w.device.type == "cpu":
        a = assign.long()
        return voted_predict_batched_plain(w[a], count[a], X)
    if w.device.type != "cuda":
        raise NotImplementedError(f"no voted-predict kernel for device "
                                  f"{w.device}")
    return _launch(w, count, X, assign)


# Kernel launches so far; only the CUDA path counts. Bound to the wrapper
# object itself, so the count survives a caller wrapping the module
# attribute.
voted_predict_batched.launches = 0
_VOTED = voted_predict_batched
