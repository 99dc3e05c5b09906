"""Whisper-style encoder-decoder of the port (arXiv:2212.04356).

Port of ``src/repro/models/encdec.py``.  The mel-spectrogram + conv
frontend is the allowed stub: callers supply frame embeddings [B,
enc_seq, d_model] (``Model.input_specs``; enc_seq = 1500 for 30 s of
audio).  Downstream: learned positions, pre-norm encoder blocks with
bidirectional attention, decoder blocks with causal self-attention (no
RoPE) and cross-attention to the encoder output.  Attention is the plain
``layers._sdpa``, as in the JAX package: the encoder is bidirectional and
cross-attention is not causal, so no flash kernel applies.

The decode cache is ``{"pos": int32 [B], "self": [{"k", "v"}], "cross_k":
[...], "cross_v": [...]}``: one position per row, as the decoder-only
caches keep it (the JAX package keeps a scalar).  Decode writes each row's
self-attention K/V at its own position, in place.

Different by design: the decoder context is its learned positions
(``cfg.max_seq``, 448 for whisper) and the self-attention cache's rows.
The JAX package clamps a step past either (``dynamic_slice_in_dim`` on the
positions, ``dynamic_update_slice`` on the cache), so a 449th token reuses
position 447 and overwrites row 447; the port raises instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..device import DeviceLike, make_generator, resolve_device
from . import layers as L
from .config import ModelConfig


def _xattn_init(g: torch.Generator, cfg: ModelConfig, device) -> Dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    dt = L.torch_dtype(cfg.dtype)
    return {"wq": L.dense_init(g, d, h * hd, dt, device),
            "wk": L.dense_init(g, d, h * hd, dt, device),
            "wv": L.dense_init(g, d, h * hd, dt, device),
            "wo": L.dense_init(g, h * hd, d, dt, device)}


def enc_block_init(g: torch.Generator, cfg: ModelConfig, device) -> Dict:
    return {"norm1": L.norm_init(cfg.d_model, cfg, device),
            "attn": L.attn_init(g, cfg, device),
            "norm2": L.norm_init(cfg.d_model, cfg, device),
            "mlp": L.mlp_init(g, cfg, device)}


def dec_block_init(g: torch.Generator, cfg: ModelConfig, device) -> Dict:
    return {"norm1": L.norm_init(cfg.d_model, cfg, device),
            "attn": L.attn_init(g, cfg, device),
            "norm_x": L.norm_init(cfg.d_model, cfg, device),
            "xattn": _xattn_init(g, cfg, device),
            "norm2": L.norm_init(cfg.d_model, cfg, device),
            "mlp": L.mlp_init(g, cfg, device)}


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict:
    """Random weights with the JAX package's keys, shapes, scales and
    dtypes (norms f32, the rest ``cfg.dtype``), not its numbers."""
    dev = resolve_device(device)
    g = generator if generator is not None else make_generator(0, dev)
    dt = L.torch_dtype(cfg.dtype)
    max_dec = cfg.max_seq or 448
    embed = L.embed_init(g, cfg, dev)
    pos_enc = torch.randn((cfg.enc_seq, cfg.d_model), generator=g,
                          device=dev).mul_(0.01).to(dt)
    pos_dec = torch.randn((max_dec, cfg.d_model), generator=g,
                          device=dev).mul_(0.01).to(dt)
    return {
        "embed": embed, "pos_enc": pos_enc, "pos_dec": pos_dec,
        "enc_layers": [enc_block_init(g, cfg, dev)
                       for _ in range(cfg.n_enc_layers)],
        "dec_layers": [dec_block_init(g, cfg, dev)
                       for _ in range(cfg.n_layers)],
        "enc_final": L.norm_init(cfg.d_model, cfg, dev),
        "dec_final": L.norm_init(cfg.d_model, cfg, dev),
    }


def _heads(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    b, s, _ = x.shape
    return (x @ w).reshape(b, s, cfg.n_heads, cfg.resolved_head_dim)


def _bidir_attn(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Encoder self-attention: no mask, no RoPE (learned positions)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    out = L._sdpa(_heads(x, p["wq"], cfg), _heads(x, p["wk"], cfg),
                  _heads(x, p["wv"], cfg), None, None, h, h)
    return out.reshape(b, s, -1) @ p["wo"]


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames [B, enc_seq, d_model], the conv frontend's embeddings ->
    encoder output [B, enc_seq, d_model]."""
    x = frames.to(L.torch_dtype(cfg.dtype)) + params["pos_enc"][None]
    for p in params["enc_layers"]:
        x = x + _bidir_attn(p["attn"], cfg, L.apply_norm(p["norm1"], x, cfg))
        x = x + L.apply_mlp(p["mlp"], cfg, L.apply_norm(p["norm2"], x, cfg))
    return L.apply_norm(params["enc_final"], x, cfg)


def _cross_attn(p: Dict, cfg: ModelConfig, x, enc_k, enc_v) -> torch.Tensor:
    b, s, _ = x.shape
    h = cfg.n_heads
    out = L._sdpa(_heads(x, p["wq"], cfg), enc_k, enc_v, None, None, h, h)
    return out.reshape(b, s, -1) @ p["wo"]


def _enc_kv(p: Dict, cfg: ModelConfig, enc_out: torch.Tensor):
    return _heads(enc_out, p["wk"], cfg), _heads(enc_out, p["wv"], cfg)


_NOROPE_CACHE: Dict[int, ModelConfig] = {}


def _norope(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` without RoPE: the decoder's positions are learned."""
    key = id(cfg)
    if key not in _NOROPE_CACHE:
        _NOROPE_CACHE[key] = dataclasses.replace(cfg, rope_frac=0.0)
    return _NOROPE_CACHE[key]


def _dec_block(p: Dict, cfg: ModelConfig, x, self_attn, enc_k, enc_v):
    """One decoder block around its self-attention ``self_attn(h) ->
    [B, S, H * hd]`` (teacher-forced or against the cache)."""
    b, s, _ = x.shape
    x = x + self_attn(L.apply_norm(p["norm1"], x, cfg)).reshape(b, s, -1) \
        @ p["attn"]["wo"]
    x = x + _cross_attn(p["xattn"], cfg, L.apply_norm(p["norm_x"], x, cfg),
                        enc_k, enc_v)
    return x + L.apply_mlp(p["mlp"], cfg, L.apply_norm(p["norm2"], x, cfg))


def _causal_self(p: Dict, cfg: ModelConfig, pos: torch.Tensor, kv_out=None):
    """Teacher-forced causal self-attention over positions ``pos`` [B, S];
    ``kv_out`` (a list) receives the block's (k, v)."""
    def attn(h):
        q, k, v = L._qkv(p["attn"], _norope(cfg), h, pos)
        if kv_out is not None:
            kv_out.append((k, v))
        return L._sdpa(q, k, v, L.causal_mask(pos, pos, None), None,
                       cfg.n_heads, cfg.n_kv_heads)
    return attn


def _dec_embed(params, cfg: ModelConfig, tokens: torch.Tensor):
    b, s = tokens.shape
    x = L.embed(params["embed"], cfg, tokens) + params["pos_dec"][None, :s]
    pos = torch.arange(s, dtype=torch.int32, device=tokens.device)
    return x, pos[None].expand(b, s)


def decode_train(params, cfg: ModelConfig, tokens: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder pass: tokens [B, S] -> logits [B, S, vocab]."""
    x, pos = _dec_embed(params, cfg, tokens)
    for p in params["dec_layers"]:
        x = _dec_block(p, cfg, x, _causal_self(p, cfg, pos),
                       *_enc_kv(p["xattn"], cfg, enc_out))
    x = L.apply_norm(params["dec_final"], x, cfg)
    return L.unembed(params["embed"], cfg, x)


def train(params, cfg: ModelConfig, frames: torch.Tensor,
          tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (logits [B, S, vocab], aux 0); differentiable (autograd)."""
    logits = decode_train(params, cfg, tokens, encode(params, cfg, frames))
    return logits, torch.zeros((), device=logits.device)


def _max_dec(cfg: ModelConfig, max_seq: int) -> int:
    return min(max_seq, cfg.max_seq or 448)


def cache_init(cfg: ModelConfig, batch: int, max_seq: int,
               device: DeviceLike = None) -> Dict:
    dev = resolve_device(device)
    rows = _max_dec(cfg, max_seq)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dt = L.torch_dtype(cfg.dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "self": [{"k": zeros(batch, rows, kv, hd),
                      "v": zeros(batch, rows, kv, hd)}
                     for _ in range(cfg.n_layers)],
            "cross_k": [zeros(batch, cfg.enc_seq, h, hd)
                        for _ in range(cfg.n_layers)],
            "cross_v": [zeros(batch, cfg.enc_seq, h, hd)
                        for _ in range(cfg.n_layers)]}


def prefill(params, cfg: ModelConfig, frames: torch.Tensor,
            tokens: torch.Tensor, max_seq: int) -> Tuple[torch.Tensor, Dict]:
    """Encode the audio and teacher-force the prompt, building the decode
    cache -> (logits of the last position [B, vocab], cache with ``pos ==
    S`` for every row)."""
    b, s = tokens.shape
    rows = _max_dec(cfg, max_seq)
    if s > rows:
        raise ValueError(f"prompt of {s} tokens exceeds the decoder's "
                         f"{rows} positions")
    enc_out = encode(params, cfg, frames)
    cache = cache_init(cfg, b, max_seq, tokens.device)
    x, pos = _dec_embed(params, cfg, tokens)
    for i, p in enumerate(params["dec_layers"]):
        kv = []
        enc_k, enc_v = _enc_kv(p["xattn"], cfg, enc_out)
        x = _dec_block(p, cfg, x, _causal_self(p, cfg, pos, kv), enc_k,
                       enc_v)
        cache["self"][i]["k"][:, :s] = kv[0][0]
        cache["self"][i]["v"][:, :s] = kv[0][1]
        cache["cross_k"][i] = enc_k
        cache["cross_v"][i] = enc_v
    x = L.apply_norm(params["dec_final"], x[:, -1:], cfg)
    logits = L.unembed(params["embed"], cfg, x)[:, 0]
    cache["pos"].fill_(s)
    return logits, cache


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache: Dict
                ) -> Tuple[torch.Tensor, Dict]:
    """token int [B] -> (logits [B, vocab], cache).  Each row decodes at its
    own ``cache["pos"]``; its K/V row is written in place and ``pos``
    advances by one.  A row at or past the decoder's last position is an
    error where the JAX package clamps (module docstring): on the CPU a
    ``ValueError``; on the card an asynchronous device-side assert, which
    needs no host sync (so a CUDA graph can capture the step) and fails
    the stream at its next synchronisation."""
    b = token.shape[0]
    pos = cache["pos"]
    limit = min(cache["self"][0]["k"].shape[1], params["pos_dec"].shape[0])
    if pos.is_cuda or pos.is_meta:        # no host read: graphs, meta traces
        torch._assert_async((pos < limit).all(),
                            f"decoder position past the decoder's {limit} "
                            f"positions")
    elif bool((pos >= limit).any()):
        raise ValueError(f"decoder position {int(pos.max())} is past the "
                         f"decoder's {limit} positions")
    x = L.embed(params["embed"], cfg, token[:, None]) + \
        params["pos_dec"][pos.long()][:, None]
    rows = torch.arange(b, device=token.device)
    size = cache["self"][0]["k"].shape[1]
    valid = torch.arange(size, device=token.device)[None] <= pos[:, None]
    mask = valid[:, None, :]                                 # [B, 1, size]
    positions = pos[:, None]
    for i, p in enumerate(params["dec_layers"]):
        sc = cache["self"][i]

        def attn(h, p=p, sc=sc):
            q, k1, v1 = L._qkv(p["attn"], _norope(cfg), h, positions)
            sc["k"][rows, pos.long()] = k1[:, 0]
            sc["v"][rows, pos.long()] = v1[:, 0]
            return L._sdpa(q, sc["k"], sc["v"], mask, None, cfg.n_heads,
                           cfg.n_kv_heads)
        x = _dec_block(p, cfg, x, attn, cache["cross_k"][i],
                       cache["cross_v"][i])
    x = L.apply_norm(params["dec_final"], x, cfg)
    logits = L.unembed(params["embed"], cfg, x)[:, 0]
    cache["pos"] = pos + 1
    return logits, cache
