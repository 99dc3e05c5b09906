"""Stream buffers: the unit of data flowing through pipelines.

Port of ``src/repro/core/buffers.py``.  A ``StreamBuffer`` mirrors a
GstBuffer: tensor payload(s) + presentation timestamp + a metadata dict
(client-id tags, topic, ...).  The JAX package registers buffers as pytrees;
the port has its own small flatten (:func:`tree_flatten`) over dicts,
lists, tuples, StreamBuffers and the codec payloads, which gives
:func:`structure_key`, :func:`stack_buffers` and :func:`unstack_buffers`
the same meaning.  SPARSE frames carry ``SparsePayload`` block-COO triples
(``tensor_sparse_enc`` and the sparse wire codec); quant8 wire frames carry
``Quant8Payload``.  A payload's static fields (``dense_shape``; ``dtype``,
``shape``, ``view2d``) are part of its treedef, so two framings never
share a structure key.  FLEXIBLE frames carry a :class:`FlexHeader` per
tensor in ``StreamBuffer.headers``: the per-frame schema header of the
paper's dynamic format (:func:`flex_wrap`, :func:`flex_unwrap`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .formats import MAX_RANK, dtype_to_tag

__all__ = ["FlexHeader", "StreamBuffer", "Quant8Payload", "SparsePayload",
           "flex_wrap", "flex_unwrap", "structure_key", "tree_flatten",
           "tree_unflatten", "stack_buffers", "unstack_buffers",
           "to_device"]


@dataclass
class FlexHeader:
    """Per-frame dynamic-schema header: ``dims`` int32 [MAX_RANK] (the true
    shape, padded with 1s), ``dtype_tag`` and ``valid`` (the number of
    valid elements), both int32 0-dim; a leading frame axis when
    stacked."""

    dims: Any
    dtype_tag: Any
    valid: Any


@dataclass
class SparsePayload:
    """Fixed-capacity block-COO: values [nb*kb], global flat indices int32
    [nb*kb], nnz int32 scalar (leading frame axis when stacked)."""

    values: Any
    indices: Any
    nnz: Any
    dense_shape: Tuple[int, ...] = ()

    @property
    def wire_nbytes(self) -> int:
        """Bytes transmitted (capacity-bounded framing): values + int32
        indices + the 4-byte count, from static shapes."""
        return int(self.values.numel() * self.values.element_size()
                   + self.indices.numel() * 4 + 4)


@dataclass
class Quant8Payload:
    """quant8 wire form: int8 tiles + one f32 scale per (32, 128) tile.
    ``dtype`` is the source dtype's tag (``formats.dtype_name``), ``shape``
    the source shape, ``view2d`` its logical 2-d view."""

    q: Any
    scale: Any
    dtype: str = "float32"
    shape: Tuple[int, ...] = ()
    view2d: Tuple[int, int] = (1, 1)

    @property
    def wire_nbytes(self) -> int:
        """Bytes transmitted: 1 per LOGICAL element + 4 per scale (the
        padded tile layout is a kernel-side detail, not wire format)."""
        n = 1
        for d in self.shape:
            n *= int(d)
        return n + int(self.scale.numel()) * 4


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
    meta in the treedef), Quant8Payload and SparsePayload (array children,
    static framing fields in the treedef); ``None`` is an empty node;
    anything else is a leaf.  Treedefs are hashable and compare equal iff
    the structures do."""
    leaves: List[Any] = []

    def go(node):
        if node is None:
            return ("none",)
        if isinstance(node, FlexHeader):
            return ("flex", go(node.dims), go(node.dtype_tag), go(node.valid))
        if isinstance(node, Quant8Payload):
            return ("quant8", go(node.q), go(node.scale), node.dtype,
                    tuple(node.shape), tuple(node.view2d))
        if isinstance(node, SparsePayload):
            return ("sparse", go(node.values), go(node.indices),
                    go(node.nnz), tuple(node.dense_shape))
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
        if kind == "flex":
            return FlexHeader(dims=go(td[1]), dtype_tag=go(td[2]),
                              valid=go(td[3]))
        if kind == "quant8":
            return Quant8Payload(q=go(td[1]), scale=go(td[2]), dtype=td[3],
                                 shape=td[4], view2d=td[5])
        if kind == "sparse":
            return SparsePayload(values=go(td[1]), indices=go(td[2]),
                                 nnz=go(td[3]), dense_shape=td[4])
        if kind == "buf":
            tensors, pts, headers = go(td[1]), go(td[2]), go(td[3])
            return StreamBuffer(tensors=tensors, pts=pts, headers=headers,
                                meta=dict(td[4]))
        if kind == "dict":
            return {k: go(c) for k, c in zip(td[1], td[2])}
        children = [go(c) for c in td[1]]
        return children if kind == "list" else tuple(children)
    return go(treedef)


def to_device(buf: "StreamBuffer", device: torch.device) -> "StreamBuffer":
    """``buf`` with every numpy leaf (an edge client's frame) made a torch
    tensor on ``device``, as the JAX package's arrays take numpy in
    implicitly.  Torch tensors stay where they are (a prompt is a host
    tensor by design).  ``buf`` itself when there is no numpy leaf."""
    leaves, treedef = tree_flatten(buf.tensors)
    if not any(isinstance(l, np.ndarray) for l in leaves):
        return buf
    moved = [torch.tensor(l, device=device)
             if isinstance(l, np.ndarray) else l for l in leaves]
    return buf.with_(tensors=tree_unflatten(treedef, moved),
                     meta=buf.meta)


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


def flex_wrap(x: torch.Tensor, capacity: int
              ) -> Tuple[torch.Tensor, FlexHeader]:
    """Encode ``x`` into a FLEXIBLE frame of ``capacity`` elements: a flat
    payload zero-padded to ``capacity`` plus a header recording the true
    dims, dtype and element count.  Shapes stay static (the capacity);
    the contents vary per frame."""
    flat = x.reshape(-1)
    n = int(flat.shape[0])
    if n > capacity:
        raise ValueError(f"frame ({n} elems) exceeds flexible capacity "
                         f"{capacity}")
    payload = torch.zeros((capacity,), dtype=x.dtype, device=x.device)
    payload[:n] = flat
    dims = [1] * MAX_RANK
    dims[:x.dim()] = x.shape
    hdr = FlexHeader(
        dims=torch.tensor(dims, dtype=torch.int32, device=x.device),
        dtype_tag=torch.tensor(dtype_to_tag(x.dtype), dtype=torch.int32,
                               device=x.device),
        valid=torch.tensor(n, dtype=torch.int32, device=x.device))
    return payload, hdr


def flex_unwrap(payload: torch.Tensor, header: FlexHeader,
                static_shape: Optional[Tuple[int, ...]] = None
                ) -> torch.Tensor:
    """Decode a FLEXIBLE frame: with ``static_shape`` (the consumer knows
    the shape from its caps) the strongly-shaped tensor, else the padded
    flat payload (the consumer must honour ``header.valid``)."""
    if static_shape is not None:
        n = int(np.prod(static_shape))
        return payload[:n].reshape(static_shape)
    return payload
