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

The source has two routes, chosen by ``voted_route`` before the launch:
``"grouped"`` (G = 2^ceil(log2 d) lanes a (query, slot) pair, a query's C
slots scored at once after one load of its node's C d floats) at d <= 32
and C <= 256, ``"strided"`` (a warp a query, its slots one after another)
for the rest: spambase's d = 57, Reuters' 9947.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gossip_cycle import (_VP, _INT, _check_tensors,
                                              _entry, _raise_on, _stream,
                                              refuse_grad)

# the kernel's routes (their codes in the C entry) and the grouped route's
# widest d and largest cache
VOTED_ROUTES = ("grouped", "strided")
GROUPED_MAX_WIDTH = 32
GROUPED_MAX_SLOTS = 256


def voted_route(d: int, c: int = 10) -> str:
    """Which route of ``csrc/voted_predict.cu`` answers queries of d
    coefficients from caches of C slots on CUDA: ``"grouped"`` at d <= 32
    and C <= 256, else ``"strided"``."""
    if d <= GROUPED_MAX_WIDTH and c <= GROUPED_MAX_SLOTS:
        return "grouped"
    return "strided"


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


def grouped_lanes_all(c: int, d: int) -> int:
    """Threads a query on the grouped route with all its C slots' groups
    at once: C G, rounded up to whole warps (at most 1024)."""
    g = 1 << max(d - 1, 0).bit_length()
    return min(-(-c * g // 32) * 32, 1024)


def _launch(w, count, X, assign, route=None, lanes=0):
    """Launch the kernel on checked operands. ``route`` overrides
    ``voted_route`` and ``lanes`` the grouped route's threads a query (a
    multiple of 32; 0 lets the kernel choose: ``grouped_lanes_all`` while
    the batch's threads fit on the card together, else 32), for holding
    the two routes to each other and timing them on the card:
    ``"grouped"`` is refused past d = 32 or C = 256; the public wrapper
    passes neither."""
    _, c, d = w.shape
    if route is None:
        route = voted_route(d, c)
    elif route not in VOTED_ROUTES or (route == "grouped" and
                                       voted_route(d, c) != route):
        raise ValueError(f"the {route!r} voted-predict route does not take "
                         f"d={d}, C={c}")
    fn, err = _entry("voted_predict", "voted_predict_batched",
                     (_VP,) * 5 + (_INT,) * 5 + (_VP,))
    m = X.shape[0]
    out = torch.empty(m, dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        code = fn(w.data_ptr(), count.data_ptr(), X.data_ptr(),
                  assign.data_ptr(), out.data_ptr(), m, c, d,
                  VOTED_ROUTES.index(route), lanes, _stream(w))
    _raise_on(code, err, f"voted_predict ({route})")
    _VOTED.launches += 1
    _VOTED.route_launches[route] += 1
    return out


def check_voted(w, count, X, assign):
    """Validate the operands: w (N, C, d) f32, count (N,) int32, X (M, d)
    f32, assign (M,) int32, all contiguous and on one device."""
    if w.ndim != 3 or X.ndim != 2:
        raise ValueError("expected w (N, C, d) and X (M, d)")
    n, c, d = w.shape
    m = X.shape[0]
    _check_tensors(w, {"w": (w, torch.float32, (n, c, d)),
                       "count": (count, torch.int32, (n,)),
                       "X": (X, torch.float32, (m, d)),
                       "assign": (assign, torch.int32, (m,))})


def voted_predict_batched(w, count, X, assign):
    """VOTEDPREDICT for M queries: w (N, C, d) f32 and count (N,) int32 are
    the whole snapshot, X (M, d) f32 the queries, and query m is answered
    by node ``assign[m]`` ((M,) int32). Returns (M,) ±1 f32. Every tensor
    must be contiguous and on one device."""
    check_voted(w, count, X, assign)
    if w.device.type == "cpu":
        a = assign.long()
        return voted_predict_batched_plain(w[a], count[a], X)
    if w.device.type != "cuda":
        raise NotImplementedError(f"no voted-predict kernel for device "
                                  f"{w.device}")
    refuse_grad("voted_predict_batched", w, X)
    return _launch(w, count, X, assign)


# Kernel launches so far, in all and by route; only the CUDA path counts.
# Bound to the wrapper object itself, so the counts survive a caller
# wrapping the module attribute.
voted_predict_batched.launches = 0
voted_predict_batched.route_launches = dict.fromkeys(VOTED_ROUTES, 0)
_VOTED = voted_predict_batched
