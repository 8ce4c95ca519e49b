"""The card's roofline constants, the mesh builders and the rank launcher.

Counterpart of ``repro/launch/mesh.py``. The constants there are the TPU
v5e's; these are the NVIDIA H100 80GB HBM3 (SXM5) card's, from NVIDIA's
H100 Tensor Core GPU datasheet: dense bf16 tensor-core peak (without
sparsity), HBM3 bandwidth, and NVLink 4's 900 GB/s a GPU counted one
direction.

A JAX mesh is one process's view of many devices. In PyTorch each device
is driven by a process of its own (a *rank*), and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of a process
group, with the reference's axis names in ``mesh_dim_names``. A rank's
process group is started by :func:`init_rank`: NCCL when every rank has
its own card, ``gloo`` when ranks share a card or run on the CPU (NCCL
refuses two ranks on one device). :func:`run_ranks` spawns the ranks of
one run and collects what each returns. Like every entry point of the
port, these run on the CUDA card unless the caller passes
``device_type="cpu"``, and raise without one.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from typing import Callable, List, Sequence

import torch

PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12                  # B/s
NVLINK_BW = 450e9                 # B/s a direction, all 18 NVLink 4 links


def _check_device_type(device_type: str) -> None:
    """The port's device rule (``utils.device.resolve_device``) for ranks:
    ``"cuda"`` needs a card, and no rank falls back to the CPU on its own."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs its ranks on a CUDA device and none is "
            "available; pass device_type='cpu' to run them on the CPU")


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the started
    process group (:func:`init_rank`), ranks in row-major order."""
    from torch.distributed.device_mesh import init_device_mesh
    _check_device_type(device_type)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def start_fake_group(world_size: int) -> None:
    """Start this process's default process group as a fake one of
    ``world_size`` ranks, this process rank 0 (PyTorch's ``FakeStore``
    and ``"fake"`` backend: collectives return without moving data, so
    only ``meta`` tensors may go on it). The dry run's stand-in for a pod
    of cards; end it with :func:`end_fake_group`."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already started in this "
                           "process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def end_fake_group() -> None:
    """End the fake group of :func:`start_fake_group` (and every mesh and
    subgroup on it); nothing in the process sees it afterwards."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_group(world_size: int):
    """:func:`start_fake_group` for the body of a ``with``, ended on the
    way out whatever happens in it."""
    start_fake_group(world_size)
    try:
        yield
    finally:
        end_fake_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's 16 x 16 ``("data", "model")`` mesh, or 2 x 16 x 16
    ``("pod", "data", "model")`` with ``multi_pod``, over the fake group
    of 256 or 512 ranks that :func:`start_fake_group` started in this
    process: shapes and placements at production size, for ``meta``
    tensors only."""
    import torch.distributed as dist
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = 512 if multi_pod else 256
    if not dist.is_initialized() or dist.get_backend() != "fake" \
            or dist.get_world_size() != world:
        raise RuntimeError(f"make_production_mesh needs the fake group of "
                           f"{world} ranks: start_fake_group({world})")
    return make_mesh(shape, axes, device_type)


def make_smoke_mesh(device_type: str = "cuda"):
    """The 1 x 1 mesh with the production axis names, over a started
    one-rank process group."""
    return make_mesh((1, 1), ("data", "model"), device_type)


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def num_chips(mesh) -> int:
    return int(mesh.mesh.numel())


def rank_backend(world_size: int, device_type: str) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``."""
    if device_type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def init_rank(rank: int, world_size: int, init_method: str, *,
              device_type: str = "cuda", timeout_s: float = 60.0) -> str:
    """Start this process's process group and return its backend.

    ``init_method`` is explicit (a ``file://`` path in a fresh directory,
    so that concurrent runs never race for a TCP port); ``timeout_s``
    bounds every collective, so a rank that dies makes the others raise
    instead of hanging. On CUDA a rank takes card ``rank % device_count``
    (all ranks share card 0 on a one-card machine), and on ``gloo`` its
    DTensor collectives are staged through host memory
    (``sharding.compat.stage_functional_collectives``)."""
    import torch.distributed as dist
    _check_device_type(device_type)
    backend = rank_backend(world_size, device_type)
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    if backend == "gloo" and device_type == "cuda":
        from repro_torch.sharding import compat
        compat.stage_functional_collectives()
    return backend


def _rank_main(rank, world_size, fn, args, init_method, device_type,
               pg_timeout_s, out_dir):
    import torch.distributed as dist
    init_rank(rank, world_size, init_method, device_type=device_type,
              timeout_s=pg_timeout_s)
    try:
        out = fn(rank, world_size, *args)
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, *args,
              device_type: str = "cuda", timeout_s: float = 300.0,
              pg_timeout_s: float = 60.0) -> List:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes, each with its process group started (:func:`init_rank`),
    and return the list of their return values, by rank.

    ``fn`` must be importable by the children (a module-level function);
    its return value is pickled. A rank that raises makes the call raise
    with its exit code; past ``timeout_s`` every rank still running is
    killed and the call raises."""
    import torch.multiprocessing as mp
    _check_device_type(device_type)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world_size, fn, args, init_method,
                                   device_type, pg_timeout_s, tmp))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
        finally:
            late = [p for p in procs if p.is_alive()]
            for p in late:
                p.kill()
            for p in late:
                p.join()
        if late:
            raise TimeoutError(f"{len(late)} of {world_size} ranks still "
                               f"ran after {timeout_s} s and were killed")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"ranks exited with codes {codes}")
        out = []
        for r in range(world_size):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
