"""Shared layers of the port (plain torch on tensors): norms, partial RoPE,
dense attention with the flash gates, float KV caches, gated MLP, embedding.

Port of ``src/repro/models/layers.py``, dense global-attention path only.
Parameters are plain dicts of tensors keyed exactly as in the JAX package
(``attn/wq``, ``norm1/scale``, ...).  Compute dtype follows ``cfg.dtype``;
norms, RoPE angles and softmax run in f32.

Decode caches hold ``k``/``v`` ``[B, S_max, kv, hd]`` and are updated IN
PLACE: a decode step writes each row's new key/value at that row's own
position (``pos`` is a per-row int32 vector).  The JAX package returns a
fresh cache instead; the values are the same.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..core.formats import TORCH_DTYPES
from ..kernels.flash_attn import flash_attention, flash_decode
from ..kernels.ref import NEG_INF
from .config import ModelConfig


def torch_dtype(name: str) -> torch.dtype:
    return TORCH_DTYPES[name]


def _dense_only(cfg: ModelConfig, window: Optional[int]):
    if window is not None:
        raise NotImplementedError("sliding-window attention: ROADMAP M5")
    if cfg.kv_cache_quant:
        raise NotImplementedError("int8 KV cache (kv_cache_quant): later "
                                  "slice of ROADMAP M4")
    if cfg.mla:
        raise NotImplementedError("MLA attention: ROADMAP M12")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def dense_init(g: torch.Generator, d_in: int, d_out: int, dtype,
               device, scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=g, device=device)
    return (w * scale).to(dtype)


def norm_init(d: int, cfg: ModelConfig, device) -> Dict:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def attn_init(g, cfg: ModelConfig, device) -> Dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    dt = torch_dtype(cfg.dtype)
    p = {"wq": dense_init(g, d, h * hd, dt, device),
         "wk": dense_init(g, d, kv * hd, dt, device),
         "wv": dense_init(g, d, kv * hd, dt, device),
         "wo": dense_init(g, h * hd, d, dt, device)}
    if cfg.qkv_bias:
        for name, n in (("bq", h), ("bk", kv), ("bv", kv)):
            p[name] = torch.zeros((n * hd,), dtype=dt, device=device)
    return p


def mlp_init(g, cfg: ModelConfig, device) -> Dict:
    d, f, dt = cfg.d_model, cfg.d_ff, torch_dtype(cfg.dtype)
    p = {"w_up": dense_init(g, d, f, dt, device),
         "w_down": dense_init(g, f, d, dt, device)}
    if cfg.mlp_glu:
        p["w_gate"] = dense_init(g, d, f, dt, device)
    return p


def embed_init(g, cfg: ModelConfig, device) -> Dict:
    dt = torch_dtype(cfg.dtype)
    tok = torch.randn((cfg.vocab, cfg.d_model), generator=g, device=device)
    p = {"tok": (tok * 0.02).to(dt)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(g, cfg.d_model, cfg.vocab, dt, device)
    return p


# ---------------------------------------------------------------------------
# norms, RoPE
# ---------------------------------------------------------------------------

def apply_norm(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    else:
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)
        y = y * p["scale"]
    return y.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, rope_frac: float,
               theta: float) -> torch.Tensor:
    """x [B, S, H, hd]; positions [B, S] absolute.  Rotates the leading
    ``rope_frac`` of hd in interleaved pairs (partial rotary)."""
    hd = x.shape[-1]
    rot = int(hd * rope_frac) // 2 * 2
    if rot == 0:
        return x
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=x.device) / rot
    freqs = 1.0 / (theta ** exps)                                  # [rot/2]
    ang = positions[..., None].float() * freqs                     # [B,S,r/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(p: Dict, cfg: ModelConfig, x: torch.Tensor, positions):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q.reshape(b, s, h, hd), positions, cfg.rope_frac,
                   cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, kv, hd), positions, cfg.rope_frac,
                   cfg.rope_theta)
    return q, k, v.reshape(b, s, kv, hd)


def _sdpa(q, k, v, mask, softcap: Optional[float], n_heads: int,
          n_kv: int) -> torch.Tensor:
    """q [B,Sq,H,hd]; k,v [B,Sk,KV,hd]; mask [B,Sq,Sk] bool or None.
    f32 logits and softmax, output in q's dtype."""
    b, sq, h, hd = q.shape
    groups = h // n_kv
    qg = q.reshape(b, sq, n_kv, groups, hd).float() * hd ** -0.5
    logits = torch.einsum("bsngh,btnh->bngst", qg, k.float())
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits,
                             torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngst,btnh->bsngh", w, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _flash_ok(cfg: ModelConfig) -> bool:
    return cfg.use_flash_attn and not cfg.logit_softcap


def attn_prefill(p: Dict, cfg: ModelConfig, x: torch.Tensor):
    """Causal self-attention over a whole sequence -> (y [B,S,d], k, v) with
    k/v [B,S,kv,hd] for the decode cache.  The projections are computed
    once (the JAX ``block_prefill`` recomputes ``_qkv`` after
    ``attn_train``; the op and its inputs are the same, so are the values).

    With ``use_flash_attn`` the attention is the K5 kernel
    (``flash_attention``), as ``layers.py:161`` gates the Pallas kernel."""
    b, s, _ = x.shape
    pos = torch.arange(s, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, cfg, x, pos[None].expand(b, s))
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if _flash_ok(cfg):
        # [B,S,H,hd] -> [B·H, S, hd]: a view for B == 1 (the serve path)
        q2 = q.permute(0, 2, 1, 3).reshape(b * h, s, hd)
        k2 = k.permute(0, 2, 1, 3).reshape(b * kvh, s, hd)
        v2 = v.permute(0, 2, 1, 3).reshape(b * kvh, s, hd)
        o2 = flash_attention(q2, k2, v2, causal=True, kv_groups=h // kvh)
        out = o2.reshape(b, h, s, hd).permute(0, 2, 1, 3)
    else:
        mask = (pos[:, None] >= pos[None, :])[None].expand(b, s, s)
        out = _sdpa(q, k, v, mask, cfg.logit_softcap, h, kvh)
    return out.reshape(b, s, h * hd) @ p["wo"], k, v


def attn_train(p: Dict, cfg: ModelConfig, x: torch.Tensor,
               window: Optional[int]) -> torch.Tensor:
    _dense_only(cfg, window)
    return attn_prefill(p, cfg, x)[0]


def attn_cache_init(cfg: ModelConfig, batch: int, max_seq: int,
                    window: Optional[int], device) -> Dict:
    _dense_only(cfg, window)
    kv, hd, dt = cfg.n_kv_heads, cfg.resolved_head_dim, torch_dtype(cfg.dtype)
    shape = (batch, max_seq, kv, hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def attn_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
                pos: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    """One-token decode for B rows.  x [B,1,d]; pos int32 [B] (each row's
    current position, on x's device); cache k/v [B,S_max,kv,hd], updated in
    place at each row's ``pos`` (clamped to the cache like JAX's
    ``dynamic_update_slice``).  Returns y [B,1,d].

    With ``use_flash_attn`` the attention is the K6 kernel
    (``flash_decode``) reading the cache in its stored layout."""
    _dense_only(cfg, window)
    b = x.shape[0]
    q, k1, v1 = _qkv(p, cfg, x, pos[:, None])
    ck, cv = cache["k"], cache["v"]
    size = ck.shape[1]
    rows = torch.arange(b, device=x.device)
    at = pos.long().clamp(0, size - 1)
    ck[rows, at] = k1[:, 0]
    cv[rows, at] = v1[:, 0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if _flash_ok(cfg):
        o2 = flash_decode(q.reshape(b * h, hd), ck, cv, pos,
                          kv_groups=h // kvh)
        out = o2.reshape(b, 1, h, hd)
    else:
        idx = torch.arange(size, device=x.device)
        mask = (idx[None, :] <= pos[:, None].long())[:, None, :]
        out = _sdpa(q, ck, cv, mask, cfg.logit_softcap, h, kvh)
    return out.reshape(b, 1, h * hd) @ p["wo"]


# ---------------------------------------------------------------------------
# MLP, embedding
# ---------------------------------------------------------------------------

def _act(cfg: ModelConfig, x):
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


def apply_mlp(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    up = x @ p["w_up"]
    h = _act(cfg, x @ p["w_gate"]) * up if "w_gate" in p else _act(cfg, up)
    return h @ p["w_down"]


def embed(p: Dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def unembed(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    return x @ w
