"""Single-controller counterparts of ``shard_map`` and its collectives.

The JAX package runs a ``shard_map`` body on every device at once, its
collectives inside.  The port runs each such body as phases split at its
collectives: a local phase once per slot, a collective over the per-slot
results, then the next local phase.  Per-slot values are numpy object
arrays of the mesh's shape, one tensor (or tree) a slot, each on its
slot's device.

* :func:`split` / :func:`gather` lay a tensor out by a :class:`~.mesh.P`
  spec and put it back together;
* :func:`psum`, :func:`pmean` and :func:`ppermute` are the collectives
  along one axis (or a tuple of axes); ``psum`` adds the slots in slot
  order, so its result does not depend on the devices;
* :func:`slot_map` runs a local phase on every slot, under its device;
* :func:`broadcast_from` gives every slot along an axis one slot's part
  (what the JAX package writes as ``psum`` of a masked value);
* :class:`Replicated` holds one copy of a tree per distinct device, not
  one per slot.

While a counter of the analysis tools is active (``kernels/cost.py``,
``launch/hlo_analysis.py``), each collective books the bytes a device
receives under the HLO kind the JAX package's collective compiles to:
``psum``, ``pmean`` and ``broadcast_from`` as ``all-reduce``,
``ppermute`` as ``collective-permute``.  A device's bytes are one slot's
output bytes, averaged over the slots: what ``collective_bytes`` reads
from a per-device HLO program.  No operation here stands for an
``all-gather``, ``reduce-scatter`` or ``all-to-all``; :func:`split` and
:func:`gather` lay tensors out at a body's boundary, as ``shard_map``'s
in and out specs do, and book nothing.  The collectives' own tensor
operations (the adds of a sum, the copies between devices) are the
communication, so the counter does not count them as operations.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..core.buffers import tree_flatten, tree_unflatten
from ..kernels import cost
from .mesh import Mesh, P

__all__ = ["split", "gather", "psum", "pmean", "ppermute", "broadcast_from",
           "axis_index", "slot_map", "slots", "Replicated", "to_device"]


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _linear(pos: Dict[str, int], sizes: Dict[str, int],
            axes: Tuple[str, ...]) -> int:
    """Row-major index of a slot over ``axes`` (the first outermost)."""
    k = 0
    for a in axes:
        k = k * sizes[a] + pos[a]
    return k


def _count(sizes: Dict[str, int], axes: Tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def to_device(tree, device: torch.device):
    """``tree`` with every tensor on ``device`` (a tensor already there is
    the same object: no copy)."""
    leaves, td = tree_flatten(tree)
    return tree_unflatten(td, [l.to(device) if isinstance(l, torch.Tensor)
                               else l for l in leaves])


def slots(mesh: Mesh) -> Iterable[Tuple[Tuple[int, ...], Dict[str, int]]]:
    """Every slot as (index tuple, {axis: position})."""
    for idx in np.ndindex(mesh.devices.shape):
        yield idx, dict(zip(mesh.axis_names, idx))


def split(x: torch.Tensor, mesh: Mesh, spec: P) -> np.ndarray:
    """The slots' parts of ``x``: dim ``i`` cut into equal contiguous
    pieces over the axes of ``spec[i]``, whole along every axis the spec
    does not name; each part on its slot's device (a view where the slot
    is on ``x``'s device)."""
    sizes = mesh.shape
    out = np.empty(mesh.devices.shape, dtype=object)
    for idx, pos in slots(mesh):
        part = x
        for dim, entry in enumerate(spec):
            axes = _axes(entry)
            if not axes:
                continue
            n = _count(sizes, axes)
            if x.shape[dim] % n:
                raise ValueError(f"split: dim {dim} of {tuple(x.shape)} "
                                 f"does not tile {n} slots of {axes}")
            step = x.shape[dim] // n
            part = part.narrow(dim, _linear(pos, sizes, axes) * step, step)
        out[idx] = part.to(mesh.devices[idx])
    return out


def gather(parts: np.ndarray, mesh: Mesh, spec: P,
           device: Optional[torch.device] = None) -> torch.Tensor:
    """Inverse of :func:`split`: the parts concatenated along each split
    dim in slot order, read from the slots at position 0 of every axis the
    spec does not name; on ``device`` (default: slot 0's)."""
    sizes = mesh.shape
    used = {a for e in spec for a in _axes(e)}
    items = {}
    for idx, pos in slots(mesh):
        if any(pos[a] for a in mesh.axis_names if a not in used):
            continue
        items[tuple(_linear(pos, sizes, _axes(e)) for e in spec)] = \
            parts[idx]
    device = device if device is not None else \
        parts[(0,) * parts.ndim].device

    def build(prefix, d):
        if d == len(spec):
            return items[prefix].to(device)
        n = _count(sizes, _axes(spec[d]))
        chunks = [build(prefix + (k,), d + 1) for k in range(n)]
        return chunks[0] if n == 1 else torch.cat(chunks, dim=d)
    return build((), 0)


def _groups(mesh: Mesh, axes: Tuple[str, ...]):
    """Slots grouped by their position on every axis but ``axes``; each
    group lists its slot indices in slot order over ``axes``."""
    sizes = mesh.shape
    groups: Dict[Tuple, List] = {}
    for idx, pos in slots(mesh):
        key = tuple(pos[a] for a in mesh.axis_names if a not in axes)
        groups.setdefault(key, []).append((_linear(pos, sizes, axes), idx))
    return [[idx for _, idx in sorted(g)] for g in groups.values()]


def _tree_add(a, b):
    la, td = tree_flatten(a)
    lb, _ = tree_flatten(b)
    return tree_unflatten(td, [x + y.to(x.device) for x, y in zip(la, lb)])


def _nbytes(tree, dtype=None) -> int:
    return sum(l.numel() * (dtype or l.dtype).itemsize
               for l in tree_flatten(tree)[0]
               if isinstance(l, torch.Tensor))


def _collective(kind: str, fn, moves: bool, dtype=None):
    """Run ``fn`` (-> per-slot parts) with the active counter paused, then
    book its mean output bytes a slot as ``kind`` (counted in ``dtype``
    where the JAX package's collective moves another dtype); nothing when
    it ``moves`` no data (one slot along the axis, no pairs), as XLA drops
    such a collective."""
    c = cost.active()
    if c is None:
        return fn()
    with c.paused():
        out = fn()
    if moves:
        c.collective(kind, sum(_nbytes(out[idx], dtype) for idx in
                               np.ndindex(out.shape)) / max(out.size, 1))
    return out


def _psum(parts: np.ndarray, mesh: Mesh, axis) -> np.ndarray:
    axes = _axes(axis)
    out = np.empty(parts.shape, dtype=object)
    for group in _groups(mesh, axes):
        total = parts[group[0]]
        for idx in group[1:]:
            total = _tree_add(total, parts[idx])
        for idx in group:
            out[idx] = to_device(total, mesh.devices[idx])
    return out


def psum(parts: np.ndarray, mesh: Mesh, axis) -> np.ndarray:
    """Sum over the slots along ``axis`` (a name or a tuple of names), in
    slot order: ((p0 + p1) + p2) + ...; every slot of a group gets the sum
    on its own device.  A part may be a tensor or a tree of tensors."""
    return _collective("all-reduce", lambda: _psum(parts, mesh, axis),
                       _count(mesh.shape, _axes(axis)) > 1)


def pmean(parts: np.ndarray, mesh: Mesh, axis) -> np.ndarray:
    """:func:`psum` divided by the slots along ``axis``."""
    n = _count(mesh.shape, _axes(axis))

    def run():
        summed = _psum(parts, mesh, axis)
        out = np.empty(parts.shape, dtype=object)
        for idx in np.ndindex(parts.shape):
            out[idx] = summed[idx] / n
        return out
    return _collective("all-reduce", run, n > 1)


def ppermute(parts: np.ndarray, mesh: Mesh, axis: str,
             pairs: List[Tuple[int, int]]) -> np.ndarray:
    """Along ``axis``: slot ``j`` gets slot ``i``'s part for every pair
    ``(i, j)``, moved to its device; a slot no pair reaches gets zeros."""
    def run():
        out = np.empty(parts.shape, dtype=object)
        src_of = {j: i for i, j in pairs}
        for group in _groups(mesh, (axis,)):
            for j, idx in enumerate(group):
                if j in src_of:
                    out[idx] = parts[group[src_of[j]]].to(mesh.devices[idx])
                else:
                    out[idx] = torch.zeros_like(parts[idx])
        return out
    return _collective("collective-permute", run, bool(pairs))


def broadcast_from(parts: np.ndarray, mesh: Mesh, axis: str, index: int,
                   wire_dtype=None) -> np.ndarray:
    """Along ``axis``: every slot gets the part of the slot at position
    ``index`` (the same tensor where both are on one device).  The JAX
    package writes this as ``psum(x * (axis_index == index))``, so it is
    booked as that all-reduce, its bytes counted in ``wire_dtype`` when
    the JAX package sums in another dtype than the part's."""
    def run():
        out = np.empty(parts.shape, dtype=object)
        for group in _groups(mesh, (axis,)):
            src = parts[group[index]]
            for idx in group:
                out[idx] = to_device(src, mesh.devices[idx])
        return out
    return _collective("all-reduce", run, mesh.shape[axis] > 1, wire_dtype)


def axis_index(mesh: Mesh, axis: str) -> np.ndarray:
    """Each slot's position along ``axis``."""
    out = np.empty(mesh.devices.shape, dtype=object)
    for idx, pos in slots(mesh):
        out[idx] = pos[axis]
    return out


def slot_map(fn: Callable, mesh: Mesh, *arrays: np.ndarray,
             n_out: int = 1):
    """``fn(*parts_of_slot)`` on every slot under its device, in slot
    order -> one object array, or ``n_out`` of them for a tuple result."""
    outs = [np.empty(mesh.devices.shape, dtype=object) for _ in range(n_out)]
    for idx, _ in slots(mesh):
        dev = mesh.devices[idx]
        args = [a[idx] for a in arrays]
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                res = fn(*args)
        else:
            res = fn(*args)
        if n_out == 1:
            outs[0][idx] = res
        else:
            for o, r in zip(outs, res):
                o[idx] = r
    return outs[0] if n_out == 1 else tuple(outs)


class Replicated:
    """A tree replicated over a mesh: one copy per distinct device (the
    tree itself on its own device), so slots that share a device share
    its tensors."""

    def __init__(self, tree: Any, devices: Iterable[torch.device]):
        self.tree = tree
        self.by_device: Dict[torch.device, Any] = {}
        for d in devices:
            if d not in self.by_device:
                self.by_device[d] = to_device(tree, d)

    def on(self, device: torch.device) -> Any:
        got = self.by_device.get(device)
        if got is None:
            got = self.by_device[device] = to_device(self.tree, device)
        return got

    def nbytes(self) -> int:
        """Device bytes the copies hold beyond the tree itself."""
        own = {l.data_ptr() for l in tree_flatten(self.tree)[0]
               if isinstance(l, torch.Tensor)}
        return sum(l.numel() * l.element_size()
                   for t in self.by_device.values()
                   for l in tree_flatten(t)[0]
                   if isinstance(l, torch.Tensor) and
                   l.data_ptr() not in own)
