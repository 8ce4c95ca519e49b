"""Tree arithmetic helpers used by the optimizers and the gossip merge.

Counterpart of ``repro/utils/tree.py``. A tree is nested dicts, lists and
tuples of tensors; a model's ``Params`` (``models/layers.py``) reads the
same way, its children as a dict and an ``nn.ModuleList`` as a list. The
helpers work leaf-wise and return plain dicts and lists. Leaves come in the
order ``jax.tree.flatten`` gives the reference's tree: dict keys sorted,
sequences in order. They are the tree generalization of the paper's vector
operations on linear models: the gossip ``merge`` (Algorithm 3) is
:func:`tree_average`, the SGD steps are :func:`tree_axpy`.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch
from torch import nn


def _children(node):
    """``(kind, keys, values)`` of an inner node, or None for a leaf."""
    if isinstance(node, nn.ModuleList):
        node = list(node)
    elif isinstance(node, nn.Module):
        node = {**dict(node.named_parameters(recurse=False)),
                **dict(node.named_children())}
    if isinstance(node, dict):
        keys = sorted(node)
        return dict, keys, [node[k] for k in keys]
    if isinstance(node, (list, tuple)):
        return type(node), list(range(len(node))), list(node)
    return None


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves in ``jax.tree.flatten``'s order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for child in kids[2] for leaf in tree_leaves(child)]


def tree_leaves_with_path(tree) -> List[Tuple[Tuple, torch.Tensor]]:
    """``(path, leaf)`` pairs in ``tree_leaves``' order, the path the tuple
    of dict keys and sequence indices from the root: the reference's
    ``jax.tree.leaves_with_path`` with each ``DictKey``/``SequenceKey``
    as its plain key or index."""
    kids = _children(tree)
    if kids is None:
        return [((), tree)]
    return [((k,) + path, leaf) for k, child in zip(kids[1], kids[2])
            for path, leaf in tree_leaves_with_path(child)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure; the result
    is built of dicts, lists and tuples (a ``Params`` becomes a dict)."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    kind, keys, values = kids
    others = [_children(r) for r in rest]
    for o in others:
        if o is None or o[1] != keys:
            raise ValueError(f"tree structures differ: keys {keys} against "
                             f"{None if o is None else o[1]}")
    out = [tree_map(fn, v, *(o[2][i] for o in others))
           for i, v in enumerate(values)]
    if kind is dict:
        return dict(zip(keys, out))
    return kind(out)


def tree_add(a, b):
    """Leaf-wise ``a + b``."""
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    """Leaf-wise ``a - b``."""
    return tree_map(torch.sub, a, b)


def tree_scale(s, a):
    """Leaf-wise ``s * a`` for a scalar ``s``."""
    return tree_map(lambda x: s * x, a)


def tree_axpy(alpha, x, y):
    """Leaf-wise ``alpha * x + y`` (the SGD update shape)."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_average(*trees, weights=None):
    """Average of trees — the paper's MERGE for arbitrary models:
    ``merge(m1, m2).w = (m1.w + m2.w) / 2`` (Algorithm 3, line 24)
    generalized to n-way, optionally weighted, averaging."""
    n = len(trees)
    if weights is None:
        return tree_map(lambda *xs: sum(xs) / n, *trees)
    wsum = sum(weights)
    return tree_map(lambda *xs: sum(w * x for w, x in zip(weights, xs))
                    / wsum, *trees)


def tree_dot(a, b) -> torch.Tensor:
    """Inner product over all leaves (float32 accumulation)."""
    parts = tree_leaves(tree_map(
        lambda x, y: torch.dot(x.float().reshape(-1), y.float().reshape(-1)),
        a, b))
    if not parts:
        return torch.zeros((), dtype=torch.float32)
    return torch.sum(torch.stack(parts))


def tree_norm(a) -> torch.Tensor:
    """Global L2 norm over all leaves."""
    return torch.sqrt(tree_dot(a, a))


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_cast(a, dtype):
    return tree_map(lambda x: x.to(dtype), a)


def tree_size(a) -> int:
    """Total number of elements across all leaves."""
    return sum(x.numel() for x in tree_leaves(a))


def tree_bytes(a) -> int:
    """Total bytes across all leaves."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(a))


def tree_random_like(generator: torch.Generator, a, scale=1.0):
    """Random-normal tree with the structure and shapes of ``a``, each leaf
    drawn in leaf order from ``generator`` (which must live on the leaves'
    device); floating leaves keep their dtype, others come out float32."""
    def draw(x):
        dtype = x.dtype if x.is_floating_point() else torch.float32
        r = torch.randn(x.shape, generator=generator, device=x.device)
        return (scale * r).to(dtype)
    return tree_map(draw, a)

