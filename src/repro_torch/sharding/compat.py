"""The per-rank body and its collectives: the port's ``shard_map_compat``.

Counterpart of ``repro/sharding/compat.py``. In JAX, ``shard_map`` runs a
body on each device's block of a global array, inside one program, and
the body talks to the other blocks through ``lax.ppermute`` and
``lax.psum``. In PyTorch there is no global array: the body runs once per
rank, in that rank's process, on that rank's shard, and the functions
below are its only communication. A mesh axis (or several, flattened in
the order given) is an :class:`Axis`: the process group of the ranks that
differ only along it, and this rank's index on it.

- :func:`ppermute`: JAX's ``(src, dst)`` pairs of axis indices; a rank
  that is no pair's destination gets zeros, as in JAX;
- :func:`exchange_rows`: rows to every other index of the axis, with
  split sizes that every rank knows from host tables (one
  ``all_to_all_single``);
- :func:`gather_rows`: every rank's rows to every rank (the same
  all-to-all, with this rank's rows sent to each; counted as the
  all-gather it is);
- :func:`psum`.

Each call adds its operand and wire bytes to :data:`STATS`, a
``launch.roofline.CollectiveStats``, as it is issued, by the reference's
algorithm-aware rules (``repro/launch/roofline.py``): an all-to-all or a
collective-permute moves its operand, an all-gather the G-1 other
shards, an all-reduce over G ranks 2·(G-1)/G of its operand. This is the port's ``parse_collectives``: PyTorch has no
HLO text to read. :data:`SECONDS` sums each op's host wall time, the
device synchronised first, so it holds the collective alone.

Transport. Every collective but the sum moves raw bytes (a ``uint8``
view of the operand), so one path serves every dtype (``gloo`` has no
int16 all-to-all). NCCL takes CUDA tensors as they are. ``gloo`` moves
host memory: on a ``gloo`` group this module copies a CUDA operand to
pinned host memory, runs the collective there, and copies the result
back. That is the transport of ranks that share a card, written here
rather than left to ``gloo``'s own CUDA paths: on an H100 with PyTorch
2.11 ``gloo`` took ``all_to_all_single``, ``all_reduce`` and
``all_gather`` of CUDA tensors, but ``send``/``recv`` and
``batch_isend_irecv`` of them killed the rank (``writev: Bad address``).
A collective that fails raises.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.roofline import CollectiveStats

STATS = CollectiveStats()
SECONDS: Dict[str, float] = {}


def reset_stats() -> None:
    """Start :data:`STATS` and :data:`SECONDS` from zero."""
    global STATS, SECONDS
    STATS, SECONDS = CollectiveStats(), {}


def _record(op: str, operand: int, wire: int, seconds: float) -> None:
    STATS.per_op[op] = STATS.per_op.get(op, 0) + operand
    STATS.count[op] = STATS.count.get(op, 0) + 1
    STATS.total_operand_bytes += operand
    STATS.wire_bytes += wire
    SECONDS[op] = SECONDS.get(op, 0.0) + seconds


@dataclass(frozen=True)
class Axis:
    """A mesh axis as a rank sees it: ``group``, the global rank at each
    index along the axis (``ranks``) and this rank's ``index``."""
    group: object
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)

    def group_rank(self, i: int) -> int:
        """Index ``i``'s rank inside ``group`` (``new_group`` orders a
        group's ranks by global rank, not by axis index)."""
        return dist.get_group_rank(self.group, self.ranks[i])


_AXES: Dict[tuple, Tuple[object, Axis]] = {}


def mesh_axis(mesh, axes: Sequence[str] = ()) -> Axis:
    """The :class:`Axis` of ``mesh``'s ``axes`` (flattened in the order
    given: index = ``sum(i_a · prod(sizes after a))``, JAX's order for a
    tuple of axis names), or of the whole process group when ``mesh`` is
    None. Groups of several axes are made once, collectively: every rank
    of the default group must ask for them in the same order."""
    me = dist.get_rank()
    if mesh is None:
        world = dist.get_world_size()
        return Axis(dist.group.WORLD, tuple(range(world)), me)
    axes = tuple(axes)
    key = (id(mesh), axes)
    if key in _AXES and _AXES[key][0] is mesh:
        return _AXES[key][1]
    names = tuple(mesh.mesh_dim_names)
    dims = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in dims]
    size = 1
    for i in dims:
        size *= mesh.mesh.shape[i]
    grid = mesh.mesh.permute(*rest, *dims).reshape(-1, size).tolist()
    row = next(r for r in grid if me in r)
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    elif sorted(row) == list(range(dist.get_world_size())):
        group = dist.group.WORLD
    else:
        group, _ = dist.new_subgroups_by_enumeration(grid)
    ax = Axis(group, tuple(row), row.index(me))
    _AXES[key] = (mesh, ax)
    return ax


def _staged(t: torch.Tensor, group) -> bool:
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


def _all_to_all(x: torch.Tensor, send: Sequence[int], recv: Sequence[int],
                axis: Axis, op: str, gathered: bool = False) -> torch.Tensor:
    """``all_to_all_single`` of ``x``'s leading dim (``send[i]`` rows to
    index i, ``recv[i]`` rows from it), by axis index; the bytes counted
    as ``op``: the operand whole, or for an all-gather (``gathered``, the
    same rows sent to every index) one copy of it, and the G-1 others'
    rows received on the wire."""
    g = axis.size
    out_rows = int(sum(recv))
    ins, outs = [0] * g, [0] * g
    for i in range(g):
        ins[axis.group_rank(i)] = int(send[i])
        outs[axis.group_rank(i)] = int(recv[i])
    _sync(x)
    t0 = time.perf_counter()
    staged = _staged(x, axis.group)
    src = _to_host(x) if staged else x.contiguous()
    out = torch.empty((out_rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=src.device, pin_memory=staged)
    dist.all_to_all_single(out, src, outs, ins, group=axis.group)
    if staged:
        out = out.to(x.device)
    _sync(out)
    nbytes = x.numel() * x.element_size()
    if gathered:
        mine = nbytes // axis.size
        _record(op, mine, out.numel() * out.element_size() - mine,
                time.perf_counter() - t0)
    else:
        _record(op, nbytes, nbytes, time.perf_counter() - t0)
    return out


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat ``uint8`` view."""
    return x.contiguous().reshape(-1).view(torch.uint8)


def ppermute(x: torch.Tensor, pairs, axis: Axis) -> torch.Tensor:
    """``lax.ppermute``: the ``x`` of the index ``src`` arrives at ``dst``
    for each pair; a rank that no pair sends to gets zeros."""
    src = {int(d): int(s) for s, d in pairs}
    dst = {int(s): int(d) for s, d in pairs}
    me = axis.index
    flat = _bytes(x)
    send, recv = [0] * axis.size, [0] * axis.size
    if me in dst:
        send[dst[me]] = flat.numel()
    if me in src:
        recv[src[me]] = flat.numel()
    out = _all_to_all(flat, send, recv, axis, "collective-permute")
    if me not in src:
        return torch.zeros_like(x)
    return out.view(x.dtype).reshape(x.shape)


def pack_rows(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """(R, ...) tensors of any dtypes -> one (R, B) ``uint8`` tensor, each
    row the bytes of every tensor's row in turn."""
    r = tensors[0].shape[0]
    return torch.cat([t.contiguous().view(torch.uint8).reshape(
        r, _row_bytes(t)) if t.numel() else torch.empty(
        (r, _row_bytes(t)), dtype=torch.uint8, device=t.device)
        for t in tensors], dim=1)


def _row_bytes(t: torch.Tensor) -> int:
    nb = t.element_size()
    for s in t.shape[1:]:
        nb *= s
    return nb


def unpack_rows(buf: torch.Tensor, like: Sequence[torch.Tensor]):
    """Invert :func:`pack_rows`: the tensors of ``buf``'s rows, shaped and
    typed as the rows of ``like``."""
    r = buf.shape[0]
    out, col = [], 0
    for t in like:
        row_shape = tuple(t.shape[1:])
        nb = _row_bytes(t)
        # a fresh copy: a view of one row may start at an offset that the
        # lane's element size does not divide
        piece = buf[:, col:col + nb].clone().reshape(-1)
        out.append(piece.view(t.dtype).reshape((r,) + row_shape))
        col += nb
    return out


def exchange_rows(tensors: Sequence[torch.Tensor], send: Sequence[int],
                  recv: Sequence[int], axis: Axis):
    """Send ``send[i]`` rows to each index ``i`` (the tensors' rows in
    index order, the same count from every tensor) and receive ``recv[i]``
    from each: one all-to-all of the rows' bytes. Returns the received
    rows of each tensor, by source index."""
    buf = pack_rows(tensors)
    out = _all_to_all(buf, send, recv, axis, "all-to-all")
    return unpack_rows(out, tensors)


def gather_rows(tensors: Sequence[torch.Tensor], counts: Sequence[int],
                axis: Axis):
    """Every index's rows on every rank, by index: ``counts[i]`` rows from
    index ``i`` (``counts[axis.index]`` is this rank's). One all-to-all
    that sends this rank's rows to each index."""
    mine = int(counts[axis.index])
    reps = [t.repeat((axis.size,) + (1,) * (t.ndim - 1)) for t in tensors]
    buf = pack_rows(reps)
    out = _all_to_all(buf, [mine] * axis.size, counts, axis, "all-gather",
                      gathered=True)
    return unpack_rows(out, tensors)


def _group_size(group_name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return dist.get_world_size(_resolve_process_group(group_name))


def _staged_call(op: str, name: str, inputs, args, wire_of):
    """Run functional collective ``name`` on pinned host copies of the
    CUDA ``inputs`` (the op's own CPU kernel), wait for it, copy the
    results back, and count each input's bytes as ``op``."""
    fn = getattr(torch.ops._c10d_functional, name)
    dev = inputs[0].device
    _sync(inputs[0])
    t0 = time.perf_counter()
    hosts = [_to_host(t) for t in inputs]
    outs = fn(hosts if name.endswith("coalesced") else hosts[0], *args)
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    outs = [torch.ops._c10d_functional.wait_tensor(o).to(dev) for o in outs]
    _sync(outs[0])
    seconds = time.perf_counter() - t0
    for t in inputs:
        nbytes = t.numel() * t.element_size()
        _record(op, nbytes, wire_of(nbytes), seconds / len(inputs))
    return outs


_STAGED_LIB = None


def stage_functional_collectives() -> None:
    """Route the functional collectives (``torch.ops._c10d_functional``,
    which DTensor's redistributions and ``full_tensor`` issue) of CUDA
    tensors through pinned host memory, as the collectives above are
    routed on a ``gloo`` group: on an H100 with PyTorch 2.11 ``gloo`` ran
    ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
    ``all_to_all_single``, ``all_reduce``, ``broadcast`` and ``scatter``
    of CUDA tensors through ``torch.distributed``, but the first DTensor
    redistribution of a CUDA tensor killed both ranks (SIGSEGV). A CUDA
    implementation of each op is registered over the library's own; it
    runs the op's CPU kernel on host copies. Each call is counted in
    :data:`STATS` by the rules of the module docstring (a reduce-scatter
    as the all-reduce's first half: (G-1)/G of its operand on the wire).
    For the ranks of one process group that share a card (``gloo``);
    once a process, kept until it exits."""
    global _STAGED_LIB
    if _STAGED_LIB is not None:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")

    def all_reduce(x, reduce_op, group_name):
        g = _group_size(group_name)
        return _staged_call("all-reduce", "all_reduce", [x],
                            (reduce_op, group_name),
                            lambda n: 2 * n * (g - 1) // max(g, 1))[0]

    def all_reduce_(x, reduce_op, group_name):
        return x.copy_(all_reduce(x, reduce_op, group_name))

    def all_reduce_coalesced(xs, reduce_op, group_name):
        g = _group_size(group_name)
        return _staged_call("all-reduce", "all_reduce_coalesced", list(xs),
                            (reduce_op, group_name),
                            lambda n: 2 * n * (g - 1) // max(g, 1))

    def all_gather_into_tensor(x, group_size, group_name):
        return _staged_call("all-gather", "all_gather_into_tensor", [x],
                            (group_size, group_name),
                            lambda n: n * (group_size - 1))[0]

    def all_gather_into_tensor_coalesced(xs, group_size, group_name):
        return _staged_call("all-gather", "all_gather_into_tensor_coalesced",
                            list(xs), (group_size, group_name),
                            lambda n: n * (group_size - 1))

    def reduce_scatter_tensor(x, reduce_op, group_size, group_name):
        return _staged_call("reduce-scatter", "reduce_scatter_tensor", [x],
                            (reduce_op, group_size, group_name),
                            lambda n: n * (group_size - 1) // group_size)[0]

    def reduce_scatter_tensor_coalesced(xs, reduce_op, group_size,
                                        group_name):
        return _staged_call("reduce-scatter",
                            "reduce_scatter_tensor_coalesced", list(xs),
                            (reduce_op, group_size, group_name),
                            lambda n: n * (group_size - 1) // group_size)

    def all_to_all_single(x, output_split_sizes, input_split_sizes,
                          group_name):
        return _staged_call("all-to-all", "all_to_all_single", [x],
                            (output_split_sizes, input_split_sizes,
                             group_name), lambda n: n)[0]

    def broadcast(x, src, group_name):
        return _staged_call("broadcast", "broadcast", [x], (src, group_name),
                            lambda n: n)[0]

    for fn in (all_reduce, all_reduce_, all_reduce_coalesced,
               all_gather_into_tensor, all_gather_into_tensor_coalesced,
               reduce_scatter_tensor, reduce_scatter_tensor_coalesced,
               all_to_all_single, broadcast):
        lib.impl(fn.__name__, fn, "CUDA")
    _STAGED_LIB = lib


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``lax.psum``: the sum of every index's ``x``, on every rank (a new
    tensor)."""
    _sync(x)
    t0 = time.perf_counter()
    staged = _staged(x, axis.group)
    y = _to_host(x) if staged else x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=axis.group)
    if staged:
        y = y.to(x.device)
    _sync(y)
    g = axis.size
    nbytes = x.numel() * x.element_size()
    _record("all-reduce", nbytes, 2 * nbytes * (g - 1) // max(g, 1),
            time.perf_counter() - t0)
    return y
