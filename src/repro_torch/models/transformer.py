"""Decoder-only LM of the port: init, the weight bridge, the forward
(train-mode) pass, prefill and decode.

Port of ``src/repro/models/transformer.py`` for the list layout and the
layer kinds ``G`` (global attention), ``L`` (sliding-window attention with
a ring-buffer cache) and ``R`` (the RG-LRU recurrent block), with MLA
attention (``cfg.mla``), MoE MLPs (``cfg.is_moe_layer``: the first
``first_dense`` layers stay dense) and the int8 KV cache.  Kind ``S``
(Mamba-2) raises ``NotImplementedError`` naming ROADMAP M12b; the stacked
(scan) layout waits for M12c.  ``lm_train`` is forward only (no backward:
ROADMAP M13).

The parameter tree is a plain nested dict of tensors with the JAX package's
keys (``embed/tok``, ``embed/head``, ``layers[i]/norm1/scale``,
``layers[i]/attn/wq``, ``layers[i]/mlp/w_up``, ``final_norm/scale``, ...),
so :func:`params_from_numpy` carries a JAX tree across without renaming.

Caches are ``{"pos": int32 [B], "layers": [...]}`` with ``{"k", "v"}`` for
an attention layer (plus ``{"k_s", "v_s"}`` under ``kv_cache_quant``),
``{"c_kv", "k_rope"}`` for an MLA layer and ``{"h", "conv"}`` for a
recurrent one, the same keys wherever a cache is made: one position per
batch row, so a slot-stacked serve cache is simply a batch-S cache and a
request's prefill cache is a batch-1 cache (the JAX package keeps a
scalar ``pos`` per b=1 cache and vmaps it over slots).  Decode updates
the cache IN PLACE.  The serve and stage decode steps dispatch MoE tokens
per batch row (``per_row``), the capacity each slot has under the JAX
package's vmap; ``lm_decode`` at batch B pools the B tokens, as the
reference's does.

Ring order after a prefill longer than a windowed layer's ring: position p
sits in row ``p % size``, the row :func:`layers.attn_decode` reads it from.
The JAX package rolls the last ``size`` keys by ``-(s % size)`` instead of
``s % size`` (``transformer.py`` ``block_prefill``), which places them
right only when ``2 s % size == 0``; elsewhere its next decode steps read
and overwrite the wrong rows and leave its own teacher-forced logits.  The
port follows the decode rule, so it matches the JAX package wherever the
JAX package is right, and the teacher-forced model everywhere.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, make_generator, resolve_device
from . import layers as L
from . import mla as MLA
from . import moe as MOE
from . import rglru as RG
from .config import ModelConfig


def _check_kind(cfg: ModelConfig, layer: int) -> str:
    kind = cfg.kind(layer)
    if kind not in ("G", "L", "R"):
        raise NotImplementedError(
            f"layer kind {kind!r}: the port runs 'G', 'L' and 'R' layers; "
            f"'S' (Mamba-2 SSD) is ROADMAP M12b")
    return kind


def _window(cfg: ModelConfig, kind: str) -> Optional[int]:
    return cfg.window if kind == "L" else None


# ---------------------------------------------------------------------------
# init and the weight bridge
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict:
    """Random weights with the JAX package's keys, shapes, init scales and
    per-leaf dtypes (norms, ``rec/lam`` and the MoE router f32, the rest
    ``cfg.dtype``), not its numbers: ``torch.Generator`` is not
    ``jax.random``.  Runs on the card unless ``device="cpu"``; the
    generator must live on the same device (default: seed 0 there)."""
    dev = resolve_device(device)
    g = generator if generator is not None else make_generator(0, dev)
    layers = []
    for i in range(cfg.n_layers):
        kind = _check_kind(cfg, i)
        blk = {"norm1": L.norm_init(cfg.d_model, cfg, dev)}
        if kind == "R":
            blk["rec"] = RG.rglru_init(g, cfg, dev)
        elif cfg.mla:
            blk["attn"] = MLA.mla_init(g, cfg, dev)
        else:
            blk["attn"] = L.attn_init(g, cfg, dev)
        blk["norm2"] = L.norm_init(cfg.d_model, cfg, dev)
        if cfg.is_moe_layer(i):
            blk["moe"] = MOE.moe_init(g, cfg, dev)
        else:
            blk["mlp"] = L.mlp_init(g, cfg, dev)
        layers.append(blk)
    return {"embed": L.embed_init(g, cfg, dev), "layers": layers,
            "final_norm": L.norm_init(cfg.d_model, cfg, dev)}


def _np_to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: reinterpret the bits
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))   # a writable copy
    return t.to(device=device)


def params_from_numpy(tree, cfg: ModelConfig, device: DeviceLike = None):
    """The weight bridge: a JAX parameter tree fetched to numpy
    (``jax.device_get``) -> the port's tree, same keys, same values, each
    leaf in its own dtype: JAX already keeps every leaf in the right one
    (norms, ``rec/lam`` and the MoE router f32, the rest ``cfg.dtype``).
    Every leaf the port knows crosses as it is: MoE experts [E, d, f] and
    ``shared``, the MLA projections, a VLM's ``vis_norm``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _np_to_torch(node, dev)
    return conv(tree)


# ---------------------------------------------------------------------------
# caches and blocks
# ---------------------------------------------------------------------------

def layer_cache_init(cfg: ModelConfig, layer: int, batch: int, max_seq: int,
                     device) -> Dict:
    kind = _check_kind(cfg, layer)
    if kind == "R":
        return RG.rglru_cache_init(cfg, batch, device)
    if cfg.mla:
        return MLA.mla_cache_init(cfg, batch, max_seq, device)
    return L.attn_cache_init(cfg, batch, max_seq, _window(cfg, kind), device)


def cache_init(cfg: ModelConfig, batch: int, max_seq: int,
               device: DeviceLike = None) -> Dict:
    dev = resolve_device(device)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "layers": [layer_cache_init(cfg, i, batch, max_seq, dev)
                       for i in range(cfg.n_layers)]}


def _mlp_part(p, cfg: ModelConfig, x, per_row: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (x + MLP(norm2(x)), the MoE aux loss, or 0.0 for a dense MLP).
    ``per_row``: MoE dispatch groups by batch row (the serve and stage
    decode steps)."""
    h = L.apply_norm(p["norm2"], x, cfg)
    if "moe" in p:
        y, aux = MOE.apply_moe(p["moe"], cfg, h, per_row=per_row)
    else:
        y, aux = L.apply_mlp(p["mlp"], cfg, h), 0.0
    return x + y, aux


def _mixer_train(p, cfg: ModelConfig, kind: str, h):
    if kind == "R":
        return RG.rglru_train(p["rec"], cfg, h)
    if cfg.mla:
        return MLA.mla_train(p["attn"], cfg, h)
    return L.attn_train(p["attn"], cfg, h, _window(cfg, kind))


def block_train(p, cfg: ModelConfig, kind: str, x
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward of one block -> (x, aux)."""
    x = x + _mixer_train(p, cfg, kind, L.apply_norm(p["norm1"], x, cfg))
    return _mlp_part(p, cfg, x)


def block_prefill(p, cfg: ModelConfig, kind: str, x, max_seq: int
                  ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward of one block that also emits its decode cache:
    the recurrent state after the last position, the latent of an MLA
    layer, or the prompt's keys/values in rows ``0..S-1`` of ``max_seq``
    rows (quantised under ``kv_cache_quant``); a ring shorter than the
    prompt keeps the last ``size`` positions, position p in row
    ``p % size`` (the module docstring says how the JAX package differs)."""
    b, s, _ = x.shape
    if s > max_seq:
        raise ValueError(f"prompt of {s} tokens exceeds max_seq={max_seq}")
    h = L.apply_norm(p["norm1"], x, cfg)
    if kind == "R":
        y, cache = RG.rglru_prefill(p["rec"], cfg, h)
    elif cfg.mla:
        y, c_kv, k_rope = MLA.mla_prefill(p["attn"], cfg, h)
        cache = MLA.mla_prefill_cache(cfg, c_kv, k_rope, max_seq, x.device)
    else:
        window = _window(cfg, kind)
        y, k, v = L.attn_prefill(p["attn"], cfg, h, window)
        cache = L.attn_prefill_cache(cfg, k, v, max_seq, window, x.device)
    return _mlp_part(p, cfg, x + y)[0], cache


def block_decode(p, cfg: ModelConfig, kind: str, x, cache, pos,
                 per_row: bool = False):
    h = L.apply_norm(p["norm1"], x, cfg)
    if kind == "R":
        y = RG.rglru_decode(p["rec"], cfg, h, cache)
    elif cfg.mla:
        y = MLA.mla_decode(p["attn"], cfg, h, cache, pos)
    else:
        y = L.attn_decode(p["attn"], cfg, h, cache, pos, _window(cfg, kind))
    return _mlp_part(p, cfg, x + y, per_row)[0]


# ---------------------------------------------------------------------------
# list-layout entry points
# ---------------------------------------------------------------------------

def backbone_train(params, cfg: ModelConfig, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embedded inputs [B, S, d] through every block and the final norm ->
    (hidden [B, S, d], summed MoE aux).  Forward only."""
    aux_total = torch.zeros((), device=x.device)
    for i, p in enumerate(params["layers"]):
        x, aux = block_train(p, cfg, _check_kind(cfg, i), x)
        aux_total = aux_total + aux
    return L.apply_norm(params["final_norm"], x, cfg), aux_total


def lm_train(params, cfg: ModelConfig, tokens: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced logits [B, S, vocab] and the MoE aux loss."""
    h, aux = backbone_train(params, cfg, L.embed(params["embed"], cfg,
                                                 tokens))
    return L.unembed(params["embed"], cfg, h), aux


def lm_prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
               max_seq: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """tokens int [B, S] -> (logits of the last position [B, vocab], cache
    with ``pos == S`` for every row)."""
    x = L.embed(params["embed"], cfg, tokens)
    return lm_prefill_embedded(params, cfg, x, max_seq or tokens.shape[1])


def lm_prefill_embedded(params, cfg: ModelConfig, x: torch.Tensor,
                        max_seq: int) -> Tuple[torch.Tensor, Dict]:
    """:func:`lm_prefill` over embeddings already built, x [B, S, d] (a
    VLM's patch prefix and text) -> (last-position logits, cache)."""
    b, s = x.shape[:2]
    caches = []
    for i, p in enumerate(params["layers"]):
        x, c = block_prefill(p, cfg, _check_kind(cfg, i), x, max_seq)
        caches.append(c)
    h = L.apply_norm(params["final_norm"], x[:, -1:], cfg)
    logits = L.unembed(params["embed"], cfg, h)[:, 0]
    pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return logits, {"pos": pos, "layers": caches}


def lm_decode(params, cfg: ModelConfig, token: torch.Tensor, cache: Dict,
              advance: Optional[torch.Tensor] = None, per_row: bool = False
              ) -> Tuple[torch.Tensor, Dict]:
    """token int [B] -> (logits [B, vocab], cache).  Each row decodes at its
    own ``cache["pos"]``; the cache is updated in place and ``pos``
    advances by one, or by ``advance`` (int32 [B], 0 or 1) where given.
    ``per_row``: MoE capacity per batch row instead of pooled."""
    pos = cache["pos"]
    x = L.embed(params["embed"], cfg, token[:, None])
    for i, p in enumerate(params["layers"]):
        x = block_decode(p, cfg, _check_kind(cfg, i), x, cache["layers"][i],
                         pos, per_row)
    h = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], cfg, h)[:, 0]
    cache["pos"] = pos + (1 if advance is None else advance)
    return logits, cache


# ---------------------------------------------------------------------------
# pipeline-stage entry points (among-device hops, DESIGN.md §8)
#
# A stage is a contiguous slice [lo, hi) of the layer stack running as its
# own pipeline: stage 0 embeds, the last stage norms and unembeds, middle
# stages map activations to activations.  Layer kinds and cache shapes are
# indexed by GLOBAL layer number and each stage runs the same per-layer ops
# as ``lm_prefill``/``lm_decode``, so chaining the stages of one tree gives
# the monolithic model's values bitwise.  A stage cache is the layer slice
# of ``cache_init`` with its own per-row ``pos`` [B].
# ---------------------------------------------------------------------------

def stage_bounds(cfg: ModelConfig, stage: int, n_stages: int
                 ) -> Tuple[int, int]:
    """Global layer range [lo, hi) owned by ``stage`` of ``n_stages``."""
    if not 0 <= stage < n_stages:
        raise ValueError(f"stage {stage} not in [0, {n_stages})")
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by "
                         f"n_stages={n_stages}")
    r = cfg.n_layers // n_stages
    return stage * r, (stage + 1) * r


def stage_params(params: Dict, cfg: ModelConfig, stage: int, n_stages: int
                 ) -> Dict:
    """One stage's share of a full list-layout tree.  ``embed`` rides on
    the first stage (token embedding) and the last (unembed reads it);
    ``final_norm`` on the last.  The share holds the full tree's layer
    dicts themselves, no view of a larger tensor, so dropping the full
    tree frees the other stages' layers."""
    lo, hi = stage_bounds(cfg, stage, n_stages)
    out: Dict = {"layers": params["layers"][lo:hi]}
    if stage == 0 or stage == n_stages - 1:
        out["embed"] = params["embed"]
    if stage == n_stages - 1:
        out["final_norm"] = params["final_norm"]
    return out


def stage_cache_init(cfg: ModelConfig, stage: int, n_stages: int,
                     batch: int, max_seq: int,
                     device: DeviceLike = None) -> Dict:
    """Zero decode cache of this stage's layers: the slice of
    :func:`cache_init`, same per-layer shapes, ``pos`` int32 [batch]."""
    dev = resolve_device(device)
    lo, hi = stage_bounds(cfg, stage, n_stages)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "layers": [layer_cache_init(cfg, i, batch, max_seq, dev)
                       for i in range(lo, hi)]}


def stage_prefill(params, cfg: ModelConfig, stage: int, n_stages: int, x,
                  max_seq: int) -> Tuple[torch.Tensor, Dict]:
    """Prefill one stage: tokens [B, L] in for stage 0, activations
    [B, L, d] for later stages -> (boundary activations [B, L, d], or the
    last position's logits [B, vocab] on the last stage; this stage's
    decode cache with ``pos == L`` for every row)."""
    lo, hi = stage_bounds(cfg, stage, n_stages)
    if stage == 0:
        x = L.embed(params["embed"], cfg, x)
    b, s = x.shape[:2]
    caches = []
    for j, p in enumerate(params["layers"]):
        x, c = block_prefill(p, cfg, _check_kind(cfg, lo + j), x, max_seq)
        caches.append(c)
    out = x
    if stage == n_stages - 1:
        h = L.apply_norm(params["final_norm"], x[:, -1:], cfg)
        out = L.unembed(params["embed"], cfg, h)[:, 0]
    pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return out, {"pos": pos, "layers": caches}


def stage_decode(params, cfg: ModelConfig, stage: int, n_stages: int, x,
                 cache: Dict, advance: Optional[torch.Tensor] = None,
                 per_row: bool = False) -> Tuple[torch.Tensor, Dict]:
    """One decode step through one stage: token int [B] in for stage 0,
    activations [B, 1, d] for later stages -> (activations [B, 1, d], or
    logits [B, vocab] on the last stage; the cache, updated in place).
    ``pos`` advances by one, or by ``advance`` (int32 [B], 0 or 1), and
    ``per_row`` sets the MoE capacity, as in :func:`lm_decode`."""
    lo, hi = stage_bounds(cfg, stage, n_stages)
    pos = cache["pos"]
    if stage == 0:
        x = L.embed(params["embed"], cfg, x[:, None])
    for j, p in enumerate(params["layers"]):
        x = block_decode(p, cfg, _check_kind(cfg, lo + j), x,
                         cache["layers"][j], pos, per_row)
    out = x
    if stage == n_stages - 1:
        h = L.apply_norm(params["final_norm"], x, cfg)
        out = L.unembed(params["embed"], cfg, h)[:, 0]
    cache["pos"] = pos + (1 if advance is None else advance)
    return out, cache


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """First maximal index per row, int32 (``torch.argmax`` and
    ``jnp.argmax`` both return the first maximum)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def serve_decode_step(params, cfg: ModelConfig, cache: Dict,
                      token: torch.Tensor, active: torch.Tensor
                      ) -> torch.Tensor:
    """One continuous-batching decode tick over every slot of a batch-S
    cache: all S rows are computed (inactive rows on whatever their cache
    holds, as the JAX package computes them on zero caches; their
    recurrent state advances too, unread), only active rows advance
    ``pos`` and take a new token.  Returns the next token
    lane int32 [S].  The serve element and ``sequential_decode`` both run
    exactly this function at the same S, so every GEMM has one shape and a
    slot's values do not depend on the other slots (MoE capacity too:
    tokens dispatch per row, as each slot does under the JAX package's
    vmap)."""
    logits, _ = lm_decode(params, cfg, token, cache,
                          advance=active.to(torch.int32), per_row=True)
    return torch.where(active, greedy(logits), token)
