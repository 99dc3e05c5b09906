"""Decoder-only LM of the port: init, the weight bridge, prefill and decode.

Port of ``src/repro/models/transformer.py`` for the list layout and layer
kind ``G`` (dense global attention).  Other kinds raise
``NotImplementedError`` naming their ROADMAP item.

The parameter tree is a plain nested dict of tensors with the JAX package's
keys (``embed/tok``, ``embed/head``, ``layers[i]/norm1/scale``,
``layers[i]/attn/wq``, ``layers[i]/mlp/w_up``, ``final_norm/scale``, ...),
so :func:`params_from_numpy` carries a JAX tree across without renaming.

Caches are ``{"pos": int32 [B], "layers": [{"k", "v"}]}``: one position per
batch row, so a slot-stacked serve cache is simply a batch-S cache and a
request's prefill cache is a batch-1 cache (the JAX package keeps a scalar
``pos`` per b=1 cache and vmaps it over slots).  Decode updates the cache
IN PLACE.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, make_generator, resolve_device
from . import layers as L
from .config import ModelConfig


def _check_kind(cfg: ModelConfig, layer: int) -> str:
    kind = cfg.kind(layer)
    if kind != "G":
        raise NotImplementedError(
            f"layer kind {kind!r}: the port runs dense global attention "
            f"(kind 'G') only; 'L' and 'R' are ROADMAP M5, 'S' is M12")
    if cfg.is_moe_layer(layer):
        raise NotImplementedError("MoE layers: ROADMAP M12")
    return kind


# ---------------------------------------------------------------------------
# init and the weight bridge
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict:
    """Random weights with the JAX package's shapes, init scales and dtypes
    (not its numbers: ``torch.Generator`` is not ``jax.random``).  Runs on
    the card unless ``device="cpu"``; the generator must live on the same
    device (default: seed 0 there)."""
    dev = resolve_device(device)
    g = generator if generator is not None else make_generator(0, dev)
    layers = []
    for i in range(cfg.n_layers):
        _check_kind(cfg, i)
        layers.append({"norm1": L.norm_init(cfg.d_model, cfg, dev),
                       "attn": L.attn_init(g, cfg, dev),
                       "norm2": L.norm_init(cfg.d_model, cfg, dev),
                       "mlp": L.mlp_init(g, cfg, dev)})
    return {"embed": L.embed_init(g, cfg, dev), "layers": layers,
            "final_norm": L.norm_init(cfg.d_model, cfg, dev)}


def _np_to_torch(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: reinterpret the bits
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))   # a writable copy
    return t.to(device=device, dtype=dtype)


def params_from_numpy(tree, cfg: ModelConfig, device: DeviceLike = None):
    """The weight bridge: a JAX parameter tree fetched to numpy
    (``jax.device_get``) -> the port's tree, same keys, same values.  Norm
    parameters stay f32 and weights take ``cfg.dtype``, as in JAX."""
    dev = resolve_device(device)
    wdt = L.torch_dtype(cfg.dtype)

    def conv(node, path):
        if isinstance(node, dict):
            return {k: conv(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v, path + (i,)) for i, v in enumerate(node)]
        is_norm = any(isinstance(p, str) and "norm" in p for p in path)
        return _np_to_torch(node, torch.float32 if is_norm else wdt, dev)
    return conv(tree, ())


# ---------------------------------------------------------------------------
# caches and blocks
# ---------------------------------------------------------------------------

def cache_init(cfg: ModelConfig, batch: int, max_seq: int,
               device: DeviceLike = None) -> Dict:
    dev = resolve_device(device)
    for i in range(cfg.n_layers):
        _check_kind(cfg, i)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "layers": [L.attn_cache_init(cfg, batch, max_seq, None, dev)
                       for _ in range(cfg.n_layers)]}


def _mlp_part(p, cfg: ModelConfig, x):
    return x + L.apply_mlp(p["mlp"], cfg, L.apply_norm(p["norm2"], x, cfg))


def block_prefill(p, cfg: ModelConfig, kind: str, x, max_seq: int
                  ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward of one block that also emits its decode cache
    (``max_seq`` rows, the prompt's keys/values in the first ``S``)."""
    b, s, _ = x.shape
    if s > max_seq:
        raise ValueError(f"prompt of {s} tokens exceeds max_seq={max_seq}")
    y, k, v = L.attn_prefill(p["attn"], cfg, L.apply_norm(p["norm1"], x, cfg))
    cache = L.attn_cache_init(cfg, b, max_seq, None, x.device)
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    return _mlp_part(p, cfg, x + y), cache


def block_decode(p, cfg: ModelConfig, kind: str, x, cache, pos):
    h = L.apply_norm(p["norm1"], x, cfg)
    x = x + L.attn_decode(p["attn"], cfg, h, cache, pos, None)
    return _mlp_part(p, cfg, x)


# ---------------------------------------------------------------------------
# list-layout entry points
# ---------------------------------------------------------------------------

def lm_prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
               max_seq: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """tokens int [B, S] -> (logits of the last position [B, vocab], cache
    with ``pos == S`` for every row)."""
    b, s = tokens.shape
    max_seq = max_seq or s
    x = L.embed(params["embed"], cfg, tokens)
    caches = []
    for i, p in enumerate(params["layers"]):
        x, c = block_prefill(p, cfg, _check_kind(cfg, i), x, max_seq)
        caches.append(c)
    h = L.apply_norm(params["final_norm"], x[:, -1:], cfg)
    logits = L.unembed(params["embed"], cfg, h)[:, 0]
    pos = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    return logits, {"pos": pos, "layers": caches}


def lm_decode(params, cfg: ModelConfig, token: torch.Tensor, cache: Dict,
              advance: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Dict]:
    """token int [B] -> (logits [B, vocab], cache).  Each row decodes at its
    own ``cache["pos"]``; the cache is updated in place and ``pos``
    advances by one, or by ``advance`` (int32 [B], 0 or 1) where given."""
    pos = cache["pos"]
    x = L.embed(params["embed"], cfg, token[:, None])
    for i, p in enumerate(params["layers"]):
        x = block_decode(p, cfg, _check_kind(cfg, i), x, cache["layers"][i],
                         pos)
    h = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], cfg, h)[:, 0]
    cache["pos"] = pos + (1 if advance is None else advance)
    return logits, cache


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """First maximal index per row, int32 (``torch.argmax`` and
    ``jnp.argmax`` both return the first maximum)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def serve_decode_step(params, cfg: ModelConfig, cache: Dict,
                      token: torch.Tensor, active: torch.Tensor
                      ) -> torch.Tensor:
    """One continuous-batching decode tick over every slot of a batch-S
    cache: all S rows are computed (inactive rows on whatever their cache
    holds, as the JAX package computes them on zero caches), only active
    rows advance ``pos`` and take a new token.  Returns the next token
    lane int32 [S].  The serve element and ``sequential_decode`` both run
    exactly this function at the same S, so every GEMM has one shape and a
    slot's values do not depend on the other slots."""
    logits, _ = lm_decode(params, cfg, token, cache,
                          advance=active.to(torch.int32))
    return torch.where(active, greedy(logits), token)
