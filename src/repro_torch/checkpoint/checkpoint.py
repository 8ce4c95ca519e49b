"""Msgpack tree checkpointing, in the reference's on-disk format.

Counterpart of ``repro/checkpoint/checkpoint.py``: ``<dir>/step_<n>/``
holds ``state.msgpack`` and ``manifest.json``. ``state.msgpack`` is a
msgpack array of the tree's leaves in ``jax.tree.flatten``'s order (dict
keys sorted), each a map ``{b"__nd__": True, b"dtype": str, b"shape":
[int], b"data": bin}`` of raw little-endian bytes; bfloat16 leaves are
written as their uint16 bits under dtype ``"bfloat16"`` (numpy has no
such dtype). The bytes equal the reference's ``save_checkpoint``'s for
the same tree, so each package restores the other's checkpoints.

The machine with the card has no ``msgpack`` package, so this module
writes and reads the subset the format uses (arrays, maps, str, bin,
non-negative ints, bool) itself, with the choices ``msgpack.packb(...,
use_bin_type=True)`` makes: the shortest encoding of each value. A leaf
is a tensor (any device) or a numpy array; restore returns tensors on the
device asked for.
"""
from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, List

import numpy as np
import torch

from repro_torch.utils.tree import _children, tree_leaves, tree_map

# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------


def _pack_len(out: List[bytes], n: int, fix: int, fix_max: int, codes):
    """A container or string header: the fix form below ``fix_max``, else
    the 8-, 16- or 32-bit length form (``codes``, None where the type
    has no such form)."""
    if n < fix_max:
        out.append(bytes([fix | n]))
    elif codes[0] is not None and n < 1 << 8:
        out.append(struct.pack(">BB", codes[0], n))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", codes[1], n))
    else:
        out.append(struct.pack(">BI", codes[2], n))


def _pack(out: List[bytes], v) -> None:
    if v is True or v is False:
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, int):
        if v < 0:
            raise ValueError(f"negative int {v} is outside the format")
        if v < 0x80:
            out.append(bytes([v]))
        else:
            for code, fmt, bits in ((0xcc, ">BB", 8), (0xcd, ">BH", 16),
                                    (0xce, ">BI", 32), (0xcf, ">BQ", 64)):
                if v < 1 << bits:
                    out.append(struct.pack(fmt, code, v))
                    break
    elif isinstance(v, str):
        b = v.encode()
        _pack_len(out, len(b), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out.append(b)
    elif isinstance(v, (bytes, memoryview)):
        n = len(v) if isinstance(v, bytes) else v.nbytes
        _pack_len(out, n, 0, 0, (0xc4, 0xc5, 0xc6))
        out.append(v)
    elif isinstance(v, dict):
        _pack_len(out, len(v), 0x80, 16, (None, 0xde, 0xdf))
        for k, x in v.items():
            _pack(out, k)
            _pack(out, x)
    elif isinstance(v, list):
        _pack_len(out, len(v), 0x90, 16, (None, 0xdc, 0xdd))
        for x in v:
            _pack(out, x)
    else:
        raise TypeError(f"{type(v).__name__} is outside the format")


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, size: int) -> int:
        return int.from_bytes(self.take(size), "big")

    def value(self):
        c = self.uint(1)
        if c < 0x80:
            return c
        if c < 0x90:
            return self._map(c & 0x0f)
        if c < 0xa0:
            return self._array(c & 0x0f)
        if c < 0xc0:
            return bytes(self.take(c & 0x1f))
        if c in (0xc2, 0xc3):
            return c == 0xc3
        if c in (0xc4, 0xc5, 0xc6):               # bin 8/16/32
            return self.take(self.uint(1 << (c - 0xc4)))
        if c in (0xcc, 0xcd, 0xce, 0xcf):         # uint 8/16/32/64
            return self.uint(1 << (c - 0xcc))
        if c in (0xd9, 0xda, 0xdb):               # str 8/16/32
            return bytes(self.take(self.uint(1 << (c - 0xd9))))
        if c in (0xdc, 0xdd):                     # array 16/32
            return self._array(self.uint(2 if c == 0xdc else 4))
        if c in (0xde, 0xdf):                     # map 16/32
            return self._map(self.uint(2 if c == 0xde else 4))
        raise ValueError(f"msgpack type 0x{c:02x} is outside the format")

    def _array(self, n: int):
        return [self.value() for _ in range(n)]

    def _map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.value()
            out[bytes(k)] = self.value()
        return out


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the format's subset."""
    out: List[bytes] = []
    _pack(out, obj)
    return b"".join(out)


def unpackb(buf: bytes):
    """``msgpack.unpackb(buf, raw=True)`` for the format's subset (bin
    values come back as memoryviews of ``buf``)."""
    r = _Reader(buf)
    v = r.value()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after the msgpack value")
    return v


# ---------------------------------------------------------------------------
# leaves and the tree
# ---------------------------------------------------------------------------


def _encode_leaf(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return {b"__nd__": True, b"dtype": "bfloat16",
                    b"shape": list(x.shape),
                    b"data": x.view(torch.int16).numpy().tobytes()}
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":          # the reference's ml_dtypes type
        return {b"__nd__": True, b"dtype": "bfloat16",
                b"shape": list(x.shape), b"data": x.view(np.uint16).tobytes()}
    return {b"__nd__": True, b"dtype": x.dtype.str, b"shape": list(x.shape),
            b"data": x.tobytes()}


def _decode_leaf(d, device) -> torch.Tensor:
    shape = tuple(d[b"shape"])
    dt = d[b"dtype"].decode()
    bf16 = dt == "bfloat16"
    a = np.frombuffer(d[b"data"], np.int16 if bf16 else np.dtype(dt))
    t = torch.from_numpy(a.reshape(shape).copy())
    return (t.view(torch.bfloat16) if bf16 else t).to(device)


def treedef_str(tree) -> str:
    """The reference manifest's ``str(treedef)``: ``PyTreeDef(...)`` with
    ``*`` for each leaf."""
    def rec(node):
        kids = _children(node)
        if kids is None:
            return "None" if node is None else "*"
        kind, keys, values = kids
        if kind is dict:
            return "{" + ", ".join(f"{k!r}: {rec(v)}"
                                   for k, v in zip(keys, values)) + "}"
        inner = ", ".join(rec(v) for v in values)
        if kind is tuple:
            return f"({inner},)" if len(values) == 1 else f"({inner})"
        return f"[{inner}]"
    return f"PyTreeDef({rec(tree)})"


def save_checkpoint(ckpt_dir, step: int, state: Any) -> Path:
    d = Path(ckpt_dir) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    leaves = tree_leaves(state)
    payload = packb([_encode_leaf(x) for x in leaves])
    (d / "state.msgpack").write_bytes(payload)
    (d / "manifest.json").write_text(json.dumps({
        "step": step, "n_leaves": len(leaves), "treedef": treedef_str(state),
        "shard": 0, "n_shards": 1}))
    return d


def latest_step(ckpt_dir):
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*"))
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir, step: int, like: Any, device=None):
    """Restore into the structure of ``like`` (a tree of tensors or
    arrays: leaf count and shapes are checked) as tensors on ``device``
    (the CPU when None). Dicts come back as dicts, lists as lists."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    raw = unpackb((d / "state.msgpack").read_bytes())
    leaves = tree_leaves(like)
    if len(raw) != len(leaves):
        raise ValueError(f"checkpoint holds {len(raw)} leaves, the tree "
                         f"{len(leaves)}")
    new = iter([_decode_leaf(r, device) for r in raw])
    out = tree_map(lambda x: next(new), like)
    for a, b in zip(tree_leaves(out), leaves):
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(f"leaf shape {tuple(a.shape)} in the "
                             f"checkpoint, {tuple(b.shape)} in the tree")
    return out
