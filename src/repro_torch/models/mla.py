"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434) of the port.

Port of ``src/repro/models/mla.py``.  KV is compressed into a rank
``kv_lora_rank`` latent ``c_kv`` plus one shared RoPE key ``k_rope``;
queries optionally go through a ``q_lora`` bottleneck.  Prefill uses the
materialised form (``mla_fused_qk``: one QK product over concatenated
features; ``attn_additive_mask``: a -1e30 causal bias; ``attn_f32_logits``
off: bf16 logits, f32 softmax rounded back), decode the absorbed form: the
query is folded through ``W_uk`` and attention runs against the cached
latent, ``c_kv`` [B, S, r] and ``k_rope`` [B, S, dr].

**YaRN** (``cfg.yarn_factor``; fields the JAX package lacks, off at their
default 0).  DeepSeek-V2 stretches its L0 = 4096 trained positions
(``yarn_original``) by a factor s = 40 (Hugging Face's
``DeepseekV2YarnRotaryEmbedding``), with YaRN's published beta_fast 32 and
beta_slow 1.  With rot the rotary dims and base theta, pair i's frequency
is

    f_i = theta^(-2i / rot) * (1 - r_i)  +  theta^(-2i / rot) / s * r_i,
    r_i = clamp((i - lo) / (hi - lo), 0, 1),
    lo  = max(floor(c(beta_fast)), 0),  hi = min(ceil(c(beta_slow)), rot - 1),
    c(b) = rot * ln(L0 / (2 pi b)) / (2 ln theta)

(:func:`yarn_freqs`; ``hi`` gains 0.001 where it equals ``lo``), so the
fast pairs keep their frequency and the slow ones are divided by s.
Hugging Face multiplies cos and sin by ``mscale(s, mscale) / mscale(s,
mscale_all_dim)``, with ``mscale(s, m) = 0.1 m ln s + 1`` (1 for s <= 1):
1 where the two are equal, as DeepSeek-V2's 0.707s are, and the port has
one field for both (``yarn_mscale``).  The softmax scale ``(dn +
dr)^-0.5`` is multiplied by ``mscale(s, yarn_mscale)^2`` (1.2608^2 for
DeepSeek-V2), in the prefill and in the absorbed decode alike
(:func:`softmax_scale`).  The queries' and keys'
rope parts rotate through kernel S5 with the table of frequencies.

The reference writes the latent at one scalar ``pos``; the port's serve
cache holds a position per slot, so each row writes its own cache row and
attends over ``[0, pos[row]]``, as ``layers.attn_decode`` does.  The cache
is updated in place.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..kernels.ref import NEG_INF
from .config import ModelConfig
from .layers import (apply_norm, apply_rope, causal_bias, causal_mask,
                     dense_init, mm_to, norm_init, torch_dtype)


def _mscale(s: float, m: float) -> float:
    return 1.0 if s <= 1 else 0.1 * m * math.log(s) + 1.0


def softmax_scale(cfg: ModelConfig) -> float:
    """``(dn + dr)^-0.5``, times ``mscale(s, yarn_mscale)^2`` under YaRN
    (module docstring)."""
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    if cfg.yarn_factor and cfg.yarn_mscale:
        scale *= _mscale(cfg.yarn_factor, cfg.yarn_mscale) ** 2
    return scale


#: YaRN's published beta_fast and beta_slow (DeepSeek-V2's rope_scaling)
_BETA_FAST, _BETA_SLOW = 32.0, 1.0
#: YaRN tables by (device, fields), made outside any graph capture
_YARN: Dict[tuple, torch.Tensor] = {}


def yarn_freqs(cfg: ModelConfig, device) -> Optional[torch.Tensor]:
    """The YaRN frequencies f32 [qk_rope_dim / 2] of ``cfg`` on ``device``
    (module docstring), or None for plain RoPE.  Computed with f32 tensor
    operations, as Hugging Face's model, once a device outside a CUDA
    graph's capture (a capture computes its own copy into its pool)."""
    if not cfg.yarn_factor:
        return None
    key = (str(device), cfg.qk_rope_dim, cfg.rope_theta, cfg.yarn_factor,
           cfg.yarn_original)
    hit = _YARN.get(key)
    if hit is not None:
        return hit
    rot, theta, s = cfg.qk_rope_dim, cfg.rope_theta, cfg.yarn_factor

    def corr(b):
        return rot * math.log(cfg.yarn_original / (b * 2 * math.pi)) / \
            (2 * math.log(theta))
    lo = max(math.floor(corr(_BETA_FAST)), 0)
    hi = min(math.ceil(corr(_BETA_SLOW)), rot - 1)
    if lo == hi:
        hi += 0.001
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    extra = 1.0 / (theta ** exps)
    inter = 1.0 / (s * theta ** exps)
    ramp = ((torch.arange(rot // 2, dtype=torch.float32, device=device) - lo)
            / (hi - lo)).clamp(0, 1)
    keep = 1.0 - ramp               # Hugging Face's inv_freq_mask
    f = inter * (1 - keep) + extra * keep
    capturing = f.is_cuda and torch.cuda.is_current_stream_capturing()
    if not capturing:
        _YARN[key] = f
    return f


def _heads_init(g, shape, fan_in: int, dt, device):
    w = torch.randn(shape, generator=g, device=device)
    return w.mul_(fan_in ** -0.5).to(dt)


def mla_init(g: torch.Generator, cfg: ModelConfig, device) -> Dict:
    d, h = cfg.d_model, cfg.n_heads
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = torch_dtype(cfg.dtype)
    p = {"w_dkv": dense_init(g, d, r_kv + dr, dt, device),
         "norm_kv": norm_init(r_kv, cfg, device),
         "w_uk": _heads_init(g, (r_kv, h, dn), r_kv, dt, device),
         "w_uv": _heads_init(g, (r_kv, h, dv), r_kv, dt, device),
         "wo": dense_init(g, h * dv, d, dt, device)}
    if r_q:
        p["w_dq"] = dense_init(g, d, r_q, dt, device)
        p["norm_q"] = norm_init(r_q, cfg, device)
        p["w_uq"] = _heads_init(g, (r_q, h, dn + dr), r_q, dt, device)
    else:
        p["w_q"] = _heads_init(g, (d, h, dn + dr), d, dt, device)
    return p


def _queries(p: Dict, cfg: ModelConfig, x: torch.Tensor, positions):
    dn = cfg.qk_nope_dim
    if "w_dq" in p:
        cq = apply_norm(p["norm_q"], x @ p["w_dq"], cfg)
        q = torch.einsum("bsr,rhd->bshd", cq, p["w_uq"])
    else:
        q = torch.einsum("bsd,dhe->bshe", x, p["w_q"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, positions, 1.0, cfg.rope_theta,
                              yarn_freqs(cfg, x.device))


def _latent(p: Dict, cfg: ModelConfig, x: torch.Tensor, positions):
    r_kv = cfg.kv_lora_rank
    dkv = x @ p["w_dkv"]                                        # [B,S,r+dr]
    c_kv = apply_norm(p["norm_kv"], dkv[..., :r_kv], cfg)       # [B,S,r]
    k_rope = apply_rope(dkv[..., None, r_kv:], positions, 1.0,
                        cfg.rope_theta,
                        yarn_freqs(cfg, x.device))[:, :, 0]     # [B,S,dr]
    return c_kv, k_rope


def mla_prefill(p: Dict, cfg: ModelConfig, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal MLA over a whole sequence, materialised form -> (y [B,S,d],
    c_kv [B,S,r], k_rope [B,S,dr]) — the latent is the decode cache's
    content (computed once; the JAX ``block_prefill`` recomputes it with
    the same ops and inputs)."""
    b, s, _ = x.shape
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, \
        cfg.v_head_dim
    pos = torch.arange(s, dtype=torch.int32, device=x.device)
    positions = pos[None].expand(b, s)
    q_nope, q_rope = _queries(p, cfg, x, positions)
    c_kv, k_rope = _latent(p, cfg, x, positions)
    k_nope = torch.einsum("btr,rhd->bthd", c_kv, p["w_uk"])     # [B,S,h,dn]
    v = torch.einsum("btr,rhd->bthd", c_kv, p["w_uv"])          # [B,S,h,dv]
    scale = softmax_scale(cfg)
    acc = torch.float32 if cfg.attn_f32_logits else torch.bfloat16
    if cfg.mla_fused_qk:
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)],
                           dim=-1)
        q_full = q_full * torch.tensor(scale, dtype=q_full.dtype)
        logits = mm_to("bshd,bthd->bhst", q_full.to(acc), k_full.to(acc),
                       acc)
    else:
        logits = (mm_to("bshd,bthd->bhst", q_nope.to(acc), k_nope.to(acc),
                        acc) +
                  mm_to("bshd,btd->bhst", q_rope.to(acc), k_rope.to(acc),
                        acc)) * torch.tensor(scale, dtype=acc)
    if cfg.attn_additive_mask:
        logits = logits + causal_bias(s, None, x.device).to(logits.dtype)
    else:
        neg = NEG_INF if cfg.attn_f32_logits else -3e38
        logits = torch.where(causal_mask(pos, pos, None), logits,
                             torch.full_like(logits, neg))
    if cfg.attn_f32_logits:
        w = torch.softmax(logits, dim=-1)
    else:
        w = torch.softmax(logits.float(), dim=-1).to(acc)
    out = mm_to("bhst,bthd->bshd", w, v.to(acc), acc).to(x.dtype)
    return out.reshape(b, s, h * dv) @ p["wo"], c_kv, k_rope


def mla_train(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return mla_prefill(p, cfg, x)[0]


def mla_cache_init(cfg: ModelConfig, batch: int, max_seq: int,
                   device) -> Dict:
    dt = torch_dtype(cfg.dtype)
    return {"c_kv": torch.zeros((batch, max_seq, cfg.kv_lora_rank),
                                dtype=dt, device=device),
            "k_rope": torch.zeros((batch, max_seq, cfg.qk_rope_dim),
                                  dtype=dt, device=device)}


def mla_prefill_cache(cfg: ModelConfig, c_kv: torch.Tensor,
                      k_rope: torch.Tensor, max_seq: int, device) -> Dict:
    """The latent decode cache of a prompt: rows ``0..S-1`` of
    ``max_seq``."""
    s = c_kv.shape[1]
    cache = mla_cache_init(cfg, c_kv.shape[0], max_seq, device)
    cache["c_kv"][:, :s] = c_kv
    cache["k_rope"][:, :s] = k_rope
    return cache


def mla_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
               pos: torch.Tensor) -> torch.Tensor:
    """Absorbed-form decode for B rows.  x [B,1,d]; pos int32 [B], each
    row's position; the latent of each row goes to its own cache row
    (clamped like ``dynamic_update_slice``), in place.  -> y [B,1,d]."""
    b = x.shape[0]
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, \
        cfg.v_head_dim
    positions = pos[:, None]
    q_nope, q_rope = _queries(p, cfg, x, positions)             # [B,1,h,*]
    c1, kr1 = _latent(p, cfg, x, positions)                     # [B,1,*]
    ck, cr = cache["c_kv"], cache["k_rope"]
    size = ck.shape[1]
    rows = torch.arange(b, device=x.device)
    p_ = pos.long()
    at = p_.clamp(0, size - 1)
    ck[rows, at] = c1[:, 0]
    cr[rows, at] = kr1[:, 0]
    # absorb W_uk into q: q_lat[b,h,r] = sum_d q_nope[b,h,d] W_uk[r,h,d]
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, p["w_uk"])[:, 0]
    scale = softmax_scale(cfg)
    logits = (torch.einsum("bhr,btr->bht", q_lat.float(), ck.float()) +
              torch.einsum("bhd,btd->bht", q_rope[:, 0].float(),
                           cr.float())) * scale
    valid = torch.arange(size, device=x.device)[None, :] <= p_[:, None]
    logits = torch.where(valid[:, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)                           # [B,h,S]
    lat = torch.einsum("bht,btr->bhr", w, ck.float())           # [B,h,r]
    out = torch.einsum("bhr,rhd->bhd", lat.to(x.dtype), p["w_uv"])
    return out.reshape(b, 1, h * dv) @ p["wo"]
