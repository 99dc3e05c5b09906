"""Sharding rules (``src/repro/launch/shardings.py``): partition specs of
the parameters by tree path, of batches and caches, and the logical
activation rules that ``models/sharding.py`` installs.

Strategy (DESIGN.md §5):

* tensor-parallel over ``model``: attention q/o on the flattened head dim,
  ff hidden, MoE experts (expert-parallel when E % model == 0, else
  per-expert ff TP), vocab for embed/head;
* data-parallel over ``data`` (+ ``pod``): batch dim of activations, KV
  caches, token streams;
* long-context decode: KV sequence sharded over ``data`` (flash-decoding
  style), the ``kv_seq`` logical rule;
* divisibility-guarded: a rule whose dim does not divide the mesh axis
  falls back to replication.

The functions return trees of :class:`NamedSharding` ``(mesh, spec)`` over
the port's parameter, batch and cache trees, equal spec for spec to the
JAX package's.  The JAX package hands these layouts to XLA's partitioner;
the port places nothing from them except :func:`replicated`, which makes
one copy of a tree per distinct device of a mesh (a mesh of several slots
on one card holds one copy).  The expert-parallel MoE and the
sequence-parallel SSD split their own tensors by hand
(``models/moe.py``, ``models/ssm.py``).
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np

from ..models.config import ModelConfig
from .mesh import Mesh, P, data_axes, mesh_axis_sizes
from .spmd import Replicated

__all__ = ["NamedSharding", "activation_rules", "param_shardings",
           "stacked_param_shardings", "batch_shardings", "cache_shardings",
           "replicated", "tree_map_with_path"]


class NamedSharding(NamedTuple):
    mesh: Any
    spec: P


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def tree_map_with_path(fn: Callable, tree, path: Tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples; a path is
    the tuple of dict keys and list indices down to the leaf.  ``None`` is
    an empty subtree, as in a JAX pytree (a stacked tree with no repeated
    unit holds one)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_path(fn, v, path + (i,))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(path, tree)


def activation_rules(cfg: ModelConfig, mesh: Mesh,
                     shard_kv_seq: bool = False) -> Dict[str, Any]:
    ax = mesh_axis_sizes(mesh)
    model = ax.get("model", 1)
    dp = data_axes(mesh)
    return {
        # long-context mode (shard_kv_seq) is batch=1 by construction: the
        # data axis carries the KV sequence instead of the batch
        "batch": None if shard_kv_seq else (
            dp if len(dp) > 1 else (dp[0] if dp else None)),
        # attention-free archs under sequence-parallel SSD keep the whole
        # residual stream sequence-sharded on `model`
        "seq": "model" if (cfg.ssm_seq_parallel and cfg.attention_free)
        else None,
        "vocab": "model" if _div(cfg.vocab, model) else None,
        "ff": "model",
        "experts": "model" if _div(cfg.n_experts or model, model) else None,
        "heads": "model" if _div(cfg.n_heads or model, model) else None,
        "kv_heads": "model" if _div(cfg.n_kv_heads or model, model)
        else None,
        # decode KV sequence: long-context mode shards it on data;
        # otherwise, when kv heads can't cover the model axis (GQA kv <
        # model, or MLA's headless latent), on model
        "kv_seq": ("data" if shard_kv_seq else
                   ("model" if (cfg.mla or not _div(cfg.n_kv_heads or model,
                                                    model)) else None)),
    }


# -- parameter specs by path -------------------------------------------------

def _param_spec(cfg: ModelConfig, path: str, shape: Tuple[int, ...],
                model: int) -> P:
    def ok(dim_idx: int) -> bool:
        return _div(shape[dim_idx], model)

    if path.endswith("embed/tok"):
        return P("model", None) if ok(0) else P()
    if path.endswith("embed/head"):
        return P(None, "model") if ok(1) else P()
    if "pos_enc" in path or "pos_dec" in path:
        return P()
    if "norm" in path or path.endswith(("A_log", "D", "dt_bias", "lam")):
        return P()
    # the Mamba-2 mixer replicates: w_in packs [z|x|B|C|dt], whose split
    # boundaries do not align with a model-axis split of the channels
    if "/ssm/" in "/" + path:
        return P()
    if re.search(r"moe/(w_up|w_gate|w_down)$", path):
        if _div(cfg.n_experts, model):
            return P("model", None, None)                # expert parallel
        # intra-expert TP: f split on both sides (up/gate out, down in)
        if path.endswith("w_down"):
            return P(None, "model", None) if ok(1) else P()
        return P(None, None, "model") if ok(2) else P()
    if path.endswith("moe/router"):
        return P()
    if path.endswith(("w_uk", "w_uv", "w_uq", "w_q")):
        return P(None, "model", None) if ok(1) else P()
    if path.endswith(("w_dkv", "w_dq")):
        return P()
    if re.search(r"(attn|xattn)/w[qkv]$", path) or \
            path.endswith(("w_up", "w_gate", "w_in", "w_rec")):
        return P(None, "model") if ok(1) else P()
    if re.search(r"(attn|xattn)/wo$", path) or \
            path.endswith(("w_down", "w_out")):
        return P("model", None) if ok(0) else P()
    if path.endswith(("bq", "bk", "bv")):
        return P("model") if ok(0) else P()
    if path.endswith(("w_r", "w_i")):                     # rg-lru gates
        return P(None, "model") if ok(1) else P()
    if path.endswith("conv"):
        return P(None, "model") if ok(1) else P()
    return P()


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def param_shardings(cfg: ModelConfig, mesh: Mesh, params_shape) -> Any:
    """``params_shape``: the parameter tree (anything with ``.shape`` at
    the leaves)."""
    model = mesh_axis_sizes(mesh).get("model", 1)

    def spec(path, leaf):
        s = _param_spec(cfg, _path_str(path), tuple(leaf.shape), model)
        nd = len(leaf.shape)
        if len(s) > nd:
            s = P(*list(s)[:nd])
        if len(s) < nd:
            s = P(*([None] * (nd - len(s)) + list(s)))
        return NamedSharding(mesh, s)

    return tree_map_with_path(spec, params_shape)


def stacked_param_shardings(cfg: ModelConfig, mesh: Mesh,
                            params_shape) -> Any:
    """The same rules over the stacked layout: leaves under ``stack/``
    carry a leading [repeats] dim, and the path-matched spec applies to
    the dims after it."""
    model = mesh_axis_sizes(mesh).get("model", 1)

    def spec(path, leaf):
        pstr = _path_str(path)
        stacked = pstr.startswith("stack/") or "/stack/" in pstr
        base_shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
        s = _param_spec(cfg, pstr, base_shape, model)
        s_list = list(s)[: len(base_shape)]
        s_list += [None] * (len(base_shape) - len(s_list))
        if stacked:
            s_list = [None] + s_list
        return NamedSharding(mesh, P(*s_list))

    return tree_map_with_path(spec, params_shape)


# -- batch / cache specs -------------------------------------------------------

def _dspec(mesh: Mesh):
    ax = mesh_axis_sizes(mesh)
    dp = data_axes(mesh)
    dsize = int(np.prod([ax[a] for a in dp])) if dp else 1
    return dsize, (dp if len(dp) > 1 else (dp[0] if dp else None))


def batch_shardings(cfg: ModelConfig, mesh: Mesh, batch_shape) -> Any:
    dsize, dspec = _dspec(mesh)

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        if not shape or not _div(shape[0], dsize):
            return NamedSharding(mesh, P(*([None] * len(shape))))
        return NamedSharding(mesh, P(*([dspec] + [None] * (len(shape) - 1))))

    return tree_map_with_path(spec, batch_shape)


def cache_shardings(cfg: ModelConfig, mesh: Mesh, cache_shape,
                    shard_kv_seq: bool = False) -> Any:
    """KV caches: [.., B, S, kv, hd] batch on data (if divisible), kv heads
    on model; long-context mode shards S on data instead of batch."""
    ax = mesh_axis_sizes(mesh)
    model, data = ax.get("model", 1), ax.get("data", 1)
    dsize, dspec = _dspec(mesh)

    def spec(path, leaf):
        pstr = _path_str(path)
        shape = tuple(leaf.shape)
        nd = len(shape)
        name = pstr.rsplit("/", 1)[-1]
        if name.isdigit() and "/" in pstr:   # list leaves: cross_k/0 etc.
            name = pstr.split("/")[-2]
        name = {"cross_k": "k", "cross_v": "v"}.get(name, name)
        if name == "pos" or nd == 0:
            return NamedSharding(mesh, P())
        s = [None] * nd
        b = 1 if "groups" in pstr else 0       # stacked caches: [L, B, ...]
        if b >= nd:
            return NamedSharding(mesh, P())
        if _div(shape[b], dsize):
            s[b] = dspec
        elif shard_kv_seq and name in ("k", "v", "c_kv", "k_rope") \
                and nd > b + 1 and _div(shape[b + 1], data):
            s[b + 1] = "data"                   # flash-decoding KV shard
        if name in ("k", "v") and nd > b + 2:
            if _div(shape[b + 2], model):
                s[b + 2] = "model"              # kv heads
            elif s[b + 1] is None and _div(shape[b + 1], model):
                # kv heads don't divide the model axis: shard the cache
                # sequence over model instead
                s[b + 1] = "model"
        if name in ("c_kv", "k_rope") and nd > b + 1 and s[b + 1] is None \
                and _div(shape[b + 1], model):
            s[b + 1] = "model"                  # MLA latent: seq on model
        if name == "h" and nd > b + 1 and _div(shape[b + 1], model):
            s[b + 1] = "model"                  # recurrent state width/heads
        if name == "conv" and nd > b + 2 and _div(shape[b + 2], model):
            s[b + 2] = "model"
        return NamedSharding(mesh, P(*s))

    return tree_map_with_path(spec, cache_shape)


def replicated(mesh: Mesh, tree) -> Replicated:
    """``tree`` placed on the mesh: one copy per distinct device (the tree
    itself on its own device), shared by the slots on that device."""
    return Replicated(tree, mesh.distinct_devices())
