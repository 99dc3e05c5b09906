"""Stream buffers: the unit of data flowing through pipelines.

Port of ``src/repro/core/buffers.py``.  A ``StreamBuffer`` mirrors a
GstBuffer: tensor payload(s) + presentation timestamp + a metadata dict
(client-id tags, topic, ...).  The JAX package registers buffers as pytrees;
the port has its own small flatten (:func:`tree_flatten`) over dicts,
lists, tuples and StreamBuffers, which gives :func:`structure_key`,
:func:`stack_buffers` and :func:`unstack_buffers` the same meaning.  The
codec payload classes (quant8, sparse) wait for slice 2.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["StreamBuffer", "structure_key", "tree_flatten", "tree_unflatten",
           "stack_buffers", "unstack_buffers"]


@dataclass
class StreamBuffer:
    """One frame on a pad. ``tensors`` maps 1:1 onto the pad caps'
    TensorSpecs; ``pts`` is the presentation timestamp (ns, running time);
    ``meta`` is a host-side dict (routing tags, sync info)."""

    tensors: Tuple[Any, ...]
    pts: Any = 0
    headers: Optional[Tuple[Any, ...]] = None
    meta: Dict[str, Any] = field(default_factory=dict)

    @property
    def tensor(self):
        assert len(self.tensors) == 1, "buffer has multiple tensors"
        return self.tensors[0]

    def with_(self, **kw) -> "StreamBuffer":
        d = dict(tensors=self.tensors, pts=self.pts, headers=self.headers)
        d.update(kw)
        if "meta" not in kw:
            d["meta"] = dict(self.meta)
        return StreamBuffer(**d)

    def nbytes(self) -> int:
        n = 0
        for t in self.tensors:
            if isinstance(t, torch.Tensor):
                n += t.numel() * t.element_size()
            else:
                a = np.asarray(t)
                n += a.size * a.dtype.itemsize
        return n


# ---------------------------------------------------------------------------
# the port's flatten (what jax.tree_util does for the JAX package)
# ---------------------------------------------------------------------------

def tree_flatten(tree) -> Tuple[List[Any], Tuple]:
    """-> (leaves, treedef).  Containers: dict (sorted keys, as JAX sorts
    them), list, tuple, StreamBuffer (children tensors/pts/headers, static
    meta in the treedef); ``None`` is an empty node; anything else is a
    leaf.  Treedefs are hashable and compare equal iff the structures do."""
    leaves: List[Any] = []

    def go(node):
        if node is None:
            return ("none",)
        if isinstance(node, StreamBuffer):
            return ("buf", go(node.tensors), go(node.pts), go(node.headers),
                    tuple(sorted(node.meta.items())))
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return ("dict", keys, tuple(go(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return (kind, tuple(go(c) for c in node))
        leaves.append(node)
        return ("leaf",)
    treedef = go(tree)
    return leaves, treedef


def tree_unflatten(treedef: Tuple, leaves) -> Any:
    it = iter(leaves)

    def go(td):
        kind = td[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        if kind == "buf":
            tensors, pts, headers = go(td[1]), go(td[2]), go(td[3])
            return StreamBuffer(tensors=tensors, pts=pts, headers=headers,
                                meta=dict(td[4]))
        if kind == "dict":
            return {k: go(c) for k, c in zip(td[1], td[2])}
        children = [go(c) for c in td[1]]
        return children if kind == "list" else tuple(children)
    return go(treedef)


def _leaf_sig(leaf) -> Tuple:
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), str(leaf.dtype), leaf.device.type)
    if isinstance(leaf, np.ndarray):
        return (leaf.shape, str(leaf.dtype), "host")
    return ((), type(leaf).__name__, "host")


def structure_key(tree) -> Tuple:
    """Hashable (treedef, leaf shapes/dtypes/devices) key: two trees with
    equal keys stack into one batch.  The grouping key of the query
    batcher and the cache key of the serve tick."""
    leaves, treedef = tree_flatten(tree)
    return (treedef, tuple(_leaf_sig(l) for l in leaves))


def _stack(xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(list(xs))
    return np.stack([np.asarray(x) for x in xs])


def stack_buffers(bufs) -> Any:
    """Stack N structurally identical trees along a new leading axis;
    raises ``ValueError`` on a structure mismatch."""
    bufs = list(bufs)
    if not bufs:
        raise ValueError("stack_buffers needs at least one buffer")
    flat = [tree_flatten(b) for b in bufs]
    ref = flat[0][1]
    for _, td in flat[1:]:
        if td != ref:
            raise ValueError(
                f"cannot stack buffers with differing structure: {ref} vs {td}")
    cols = zip(*[leaves for leaves, _ in flat])
    return tree_unflatten(ref, [_stack(c) for c in cols])


def unstack_buffers(stacked, n: Optional[int] = None) -> list:
    """Inverse of :func:`stack_buffers`: split the leading frame axis."""
    leaves, treedef = tree_flatten(stacked)
    if n is None:
        if not leaves:
            raise ValueError("cannot infer burst length from a leafless tree")
        n = int(leaves[0].shape[0])
    return [tree_unflatten(treedef, [leaf[i] for leaf in leaves])
            for i in range(n)]
