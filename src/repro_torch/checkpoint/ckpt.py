"""Checkpointing of the port: a tree of tensors -> chunked ``.npz`` files
and a JSON manifest, in the JAX package's exact on-disk format
(``src/repro/checkpoint/ckpt.py``), so a checkpoint written by either
package restores bitwise in the other.

Layout: ``<dir>/step_<n:08d>/manifest.json`` + ``arrays_<k>.npz``, arrays
chunked so no file exceeds ~512 MB.  Manifest keys are ``/``-joined tree
paths in the reference's flatten order: dict keys sorted, list indices,
a NamedTuple's field names (``opt/step``, ``opt/m/...``), ``None`` an
empty node.  Each leaf is stored as numpy holds it, bf16 as its ``uint16``
bit pattern with ``"dtype": "bfloat16"`` in the manifest (numpy has no
bf16, and the port needs no ``ml_dtypes``: the bits cross through integer
views).  Tensors are copied to the host to be written and restored to the
device and dtype of the ``like`` tree's leaves.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

_CHUNK_BYTES = 512 << 20


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """-> [(path part, child)] of a container node, in flatten order, or
    None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _leaves_with_path(tree, prefix: Tuple[str, ...] = ()
                      ) -> Iterator[Tuple[str, Any]]:
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield "/".join(prefix), tree
        return
    for part, child in kids:
        yield from _leaves_with_path(child, prefix + (part,))


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """-> (the array to store, its true dtype's name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":        # an ml_dtypes array
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    d = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    chunks: List[Dict[str, np.ndarray]] = [{}]
    sizes = [0]
    manifest = {"step": step, "leaves": {}, "chunks": 0}
    for key, leaf in _leaves_with_path(tree):
        arr, true_dtype = _to_numpy(leaf)
        if sizes[-1] + arr.nbytes > _CHUNK_BYTES and chunks[-1]:
            chunks.append({})
            sizes.append(0)
        ck = len(chunks) - 1
        slot = f"a{len(chunks[ck])}"
        chunks[ck][slot] = arr
        sizes[ck] += arr.nbytes
        manifest["leaves"][key] = {"chunk": ck, "slot": slot,
                                   "shape": list(arr.shape),
                                   "dtype": true_dtype}
    manifest["chunks"] = len(chunks)
    for i, ch in enumerate(chunks):
        np.savez(os.path.join(d, f"arrays_{i}.npz"), **ch)
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return d


def _rebuild(like, fn, prefix: Tuple[str, ...] = ()):
    """``like``'s structure with each leaf replaced by fn(path, leaf)."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        return fn("/".join(prefix), like)
    out = [(part, _rebuild(c, fn, prefix + (part,))) for part, c in kids]
    if isinstance(like, dict):
        return {k: v for k, (_, v) in zip(sorted(like), out)}
    vals = [v for _, v in out]
    if _is_namedtuple(like):
        return type(like)(*vals)
    return vals if isinstance(like, list) else tuple(vals)


def load_checkpoint(directory: str, step: Optional[int] = None,
                    like: Any = None) -> Tuple[int, Any]:
    """-> (step, tree).  With ``like`` the tree has its exact structure
    (dicts, lists, NamedTuples such as ``OptState``) and each leaf the
    dtype and device of its tensor there; without, a nested dict of CPU
    tensors."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    cache: Dict[int, Any] = {}

    def restore(key: str) -> Tuple[np.ndarray, str]:
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        i = meta["chunk"]
        if i not in cache:
            cache[i] = np.load(os.path.join(d, f"arrays_{i}.npz"))
        return cache[i][meta["slot"]], meta["dtype"]

    if like is not None:
        def leaf(key, target):
            if not isinstance(target, torch.Tensor):
                raise TypeError(f"load_checkpoint: like's leaf {key!r} is "
                                f"a {type(target).__name__}, not a tensor")
            return _to_tensor(*restore(key)).to(dtype=target.dtype,
                                                device=target.device)
        return step, _rebuild(like, leaf)
    tree: Dict = {}
    for key in manifest["leaves"]:
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _to_tensor(*restore(key))
    return step, tree


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for n in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", n))]
    return max(steps) if steps else None
