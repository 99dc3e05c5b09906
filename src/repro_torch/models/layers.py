"""Shared layers of the port (plain torch on tensors): norms, partial RoPE,
GQA attention, global or sliding-window, with the flash gates, KV caches
(float, or int8 with per-(token, kv-head) f32 scales under
``kv_cache_quant``; ring buffers for windowed layers), gated MLP,
embedding.

Port of ``src/repro/models/layers.py`` (MLA lives in ``mla.py``).
Parameters are plain dicts of tensors keyed exactly as in the JAX package
(``attn/wq``, ``norm1/scale``, ...).  Compute dtype follows ``cfg.dtype``;
norms and RoPE angles run in f32 (kernels S4 and S5 on the card, one launch
a norm and one for a layer's q and k; their plain versions, the
expressions as they were, on the CPU and wherever a gradient must flow
through them), attention logits and softmax in f32
unless ``attn_f32_logits=False`` (bf16 logits, f32 softmax rounded back to
bf16, as the JAX ``_sdpa``); ``attn_additive_mask`` adds a -1e30 causal
bias in place of the boolean select in prefill.

Decode caches hold ``k``/``v`` ``[B, S_cache, kv, hd]`` and are updated IN
PLACE: a decode step writes each row's new key/value at that row's own
position (``pos`` is a per-row int32 vector).  A global layer's cache has
``max_seq`` rows and position p sits in row p; a windowed layer's is a ring
of ``min(window, max_seq)`` rows with position p in row ``p % size``.  The
JAX package returns a fresh cache instead; the values are the same.

The flash kernels (K5, K6) serve global layers only, as in the JAX package
(``layers.py`` gates them on ``window is None``): windowed layers take the
plain masked attention, and so does decode over an int8 cache.

The int8 cache: ``{"k", "v"}`` int8 and ``{"k_s", "v_s"}`` f32 ``[B, S,
kv, 1]``; a key row is stored as ``round_half_even(x / s)`` with ``s =
amax / 127`` (1 where the row is all zero) and read back as ``(q * s)`` in
``cfg.dtype``.  A prefill quantises the prompt's rows the same way (the
JAX package's ``block_prefill`` writes float rows into the int8 cache and
raises there; its decode path is the one held to).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..core.formats import TORCH_DTYPES
from ..kernels.build import needs_grad
from ..kernels.flash_attn import flash_attention, flash_decode
from ..kernels.norm import norm
from ..kernels.ref import NEG_INF, norm_plain, rotary_plain
from ..kernels.rotary import rotary, rotated_dims
from .config import ModelConfig


def torch_dtype(name: str) -> torch.dtype:
    return TORCH_DTYPES[name]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def dense_init(g: torch.Generator, d_in: int, d_out: int, dtype,
               device, scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=g, device=device)
    return w.mul_(scale).to(dtype)      # in place: one f32 copy at a time


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
    p = {"tok": tok.mul_(0.02).to(dt)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(g, cfg.d_model, cfg.vocab, dt, device)
    return p


# ---------------------------------------------------------------------------
# norms, RoPE
# ---------------------------------------------------------------------------

#: how often the eager norm and rotary expressions ran on a CUDA tensor
#: (where a gradient must flow through them; every other call on the card
#: is a launch of S4 or S5)
EAGER_ON_CARD: Dict[str, int] = {"norm": 0, "rotary": 0}


def _eager(name: str, x: torch.Tensor):
    if x.is_cuda:
        EAGER_ON_CARD[name] += 1


def apply_norm(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm, or LayerNorm under ``cfg.norm == "layernorm"``: kernel S4
    (``kernels/norm.py``; its plain version on the CPU), or the eager
    expression where a gradient must flow through it."""
    bias = p["bias"] if cfg.norm == "layernorm" else None
    if needs_grad(x, p["scale"], bias):
        _eager("norm", x)
        return norm_plain(x, p["scale"], bias)
    return norm(x, p["scale"], bias)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, rope_frac: float,
               theta: float, freqs: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """x [B, S, H, hd]; positions [B, S] absolute.  Rotates the leading
    ``rope_frac`` of hd in interleaved pairs (partial rotary), at the
    frequencies ``theta^(-2i / rot)`` or the table ``freqs`` (f32 [rot /
    2], YaRN's: ``models/mla.py``): kernel S5 (``kernels/rotary.py``), or
    the eager expression where a gradient must flow through it."""
    return rope_pair(x, None, positions, rope_frac, theta, freqs)[0]


def rope_pair(q: torch.Tensor, k: Optional[torch.Tensor],
              positions: torch.Tensor, rope_frac: float, theta: float,
              freqs: Optional[torch.Tensor] = None):
    """:func:`apply_rope` of q and of k (or None), one S5 launch for both."""
    if rotated_dims(q.shape[-1], rope_frac) and needs_grad(q, k):
        _eager("rotary", q)
        return tuple(None if t is None else
                     rotary_plain(t, positions, rope_frac, theta, freqs)
                     for t in (q, k))
    return rotary(q, k, positions, rope_frac, theta, freqs)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(p: Dict, cfg: ModelConfig, x: torch.Tensor, positions):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k = rope_pair(q.reshape(b, s, h, hd), k.reshape(b, s, kv, hd),
                     positions, cfg.rope_frac, cfg.rope_theta)
    return q, k, v.reshape(b, s, kv, hd)


def _sdpa(q, k, v, mask, softcap: Optional[float], n_heads: int,
          n_kv: int, f32_logits: bool = True,
          additive_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,Sq,H,hd]; k,v [B,Sk,KV,hd]; mask [B,Sq,Sk] bool or None;
    ``additive_mask`` [Sq,Sk] float bias in its place.  Logits in f32, or
    in bf16 with ``f32_logits=False`` (the softmax then runs in f32 and
    rounds back to bf16, masked logits at -3e38); output in q's dtype."""
    b, sq, h, hd = q.shape
    groups = h // n_kv
    acc = torch.float32 if f32_logits else torch.bfloat16
    qg = q.reshape(b, sq, n_kv, groups, hd).to(acc) * \
        torch.tensor(hd ** -0.5, dtype=acc)
    logits = mm_to("bsngh,btnh->bngst", qg, k, acc)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    if additive_mask is not None:
        logits = logits + additive_mask.to(logits.dtype)
    elif mask is not None:
        neg = NEG_INF if f32_logits else -3e38
        logits = torch.where(mask[:, None, None], logits,
                             torch.full_like(logits, neg))
    if f32_logits:
        w = torch.softmax(logits, dim=-1)
    else:
        w = torch.softmax(logits.float(), dim=-1).to(acc)
    out = mm_to("bngst,btnh->bsngh", w, v.to(acc), acc)
    return out.reshape(b, sq, h, hd).to(q.dtype)


def mm_to(eq: str, a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """``einsum`` of a and b with f32 products and sums, rounded once to
    ``dtype``: what a bf16 einsum is in the JAX package (XLA accumulates
    in f32; a bf16 ``torch.einsum`` on the CPU does not)."""
    return torch.einsum(eq, a.float(), b.float()).to(dtype)


def causal_bias(s: int, window: Optional[int], device) -> torch.Tensor:
    """The additive causal mask of ``attn_additive_mask``: 0 where query i
    may attend to key j, -1e30 elsewhere, f32 [s, s]."""
    idx = torch.arange(s, device=device)
    ok = causal_mask(idx, idx, window)
    return torch.where(ok, torch.zeros((), device=device),
                       torch.full((), NEG_INF, device=device))


def _flash_ok(cfg: ModelConfig, window: Optional[int],
              decode: bool = False) -> bool:
    """The JAX package's flash gates: global layers without a softcap; in
    decode also not over an int8 cache."""
    return cfg.use_flash_attn and window is None and \
        not cfg.logit_softcap and not (decode and cfg.kv_cache_quant)


def causal_mask(pos_q: torch.Tensor, pos_k: torch.Tensor,
                window: Optional[int]) -> torch.Tensor:
    """mask[..., i, j]: may query position i attend to key position j
    (``pos_q`` [..., Sq], ``pos_k`` [..., Sk]; the JAX ``causal_mask``)."""
    d = pos_q[..., :, None] - pos_k[..., None, :]
    m = d >= 0
    if window is not None:
        m &= d < window
    return m


def attn_prefill(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 window: Optional[int] = None):
    """Causal self-attention over a whole sequence, within ``window``
    positions if given -> (y [B,S,d], k, v) with k/v [B,S,kv,hd] for the
    decode cache.  The projections are computed once (the JAX
    ``block_prefill`` recomputes ``_qkv`` after ``attn_train``; the op and
    its inputs are the same, so are the values).

    With ``use_flash_attn`` and no window the attention is the K5 kernel
    (``flash_attention``), as ``layers.py:161`` gates the Pallas kernel."""
    b, s, _ = x.shape
    pos = torch.arange(s, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, cfg, x, pos[None].expand(b, s))
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if _flash_ok(cfg, window):
        # [B,S,H,hd] -> [B·H, S, hd]: a view for B == 1 (the serve path)
        q2 = q.permute(0, 2, 1, 3).reshape(b * h, s, hd)
        k2 = k.permute(0, 2, 1, 3).reshape(b * kvh, s, hd)
        v2 = v.permute(0, 2, 1, 3).reshape(b * kvh, s, hd)
        o2 = flash_attention(q2, k2, v2, causal=True, kv_groups=h // kvh)
        out = o2.reshape(b, h, s, hd).permute(0, 2, 1, 3)
    elif cfg.attn_additive_mask:
        out = _sdpa(q, k, v, None, cfg.logit_softcap, h, kvh,
                    f32_logits=cfg.attn_f32_logits,
                    additive_mask=causal_bias(s, window, x.device))
    else:
        mask = causal_mask(pos, pos, window)[None].expand(b, s, s)
        out = _sdpa(q, k, v, mask, cfg.logit_softcap, h, kvh,
                    f32_logits=cfg.attn_f32_logits)
    return out.reshape(b, s, h * hd) @ p["wo"], k, v


def attn_train(p: Dict, cfg: ModelConfig, x: torch.Tensor,
               window: Optional[int]) -> torch.Tensor:
    return attn_prefill(p, cfg, x, window)[0]


def attn_cache_init(cfg: ModelConfig, batch: int, max_seq: int,
                    window: Optional[int], device) -> Dict:
    """Zero K/V of ``max_seq`` rows, or a ring of ``min(window, max_seq)``
    rows for a windowed layer; int8 K/V with unit f32 scales under
    ``kv_cache_quant``."""
    kv, hd, dt = cfg.n_kv_heads, cfg.resolved_head_dim, torch_dtype(cfg.dtype)
    size = min(window, max_seq) if window is not None else max_seq
    shape = (batch, size, kv, hd)
    if cfg.kv_cache_quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.ones(shape[:3] + (1,), dtype=torch.float32,
                                  device=device),
                "v_s": torch.ones(shape[:3] + (1,), dtype=torch.float32,
                                  device=device)}
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _quant_kv(x: torch.Tensor):
    """x [..., hd] -> (int8 rows, f32 scales [..., 1]): ``amax / 127.0``
    (a division, as the JAX ``_quant_kv``; 1 for an all-zero row), values
    rounded half to even."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.round(xf / scale).to(torch.int8), scale


def attn_prefill_cache(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
                       max_seq: int, window: Optional[int], device) -> Dict:
    """The decode cache of a prompt's keys/values k, v [B, S, kv, hd]:
    rows ``0..S-1`` of ``max_seq``, or, for a ring shorter than the
    prompt, the last ``size`` positions with position p in row ``p %
    size``; quantised rows under ``kv_cache_quant``."""
    s = k.shape[1]
    cache = attn_cache_init(cfg, k.shape[0], max_seq, window, device)
    size = cache["k"].shape[1]
    rows = {"k": k, "v": v}
    if cfg.kv_cache_quant:
        rows["k"], rows["k_s"] = _quant_kv(k)
        rows["v"], rows["v_s"] = _quant_kv(v)
    for name, x in rows.items():
        if s <= size:
            cache[name][:, :s] = x
        else:       # ring: position s - size + j goes to row (s + j) % size
            cache[name].copy_(torch.roll(x[:, -size:], s % size, dims=1))
    return cache


def attn_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
                pos: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    """One-token decode for B rows.  x [B,1,d]; pos int32 [B] (each row's
    current position, on x's device); cache k/v [B,S_cache,kv,hd], updated
    in place at each row's own row of the cache: ``pos`` (clamped to the
    cache like JAX's ``dynamic_update_slice``) for a global layer,
    ``pos % size`` for a windowed layer's ring.  Returns y [B,1,d].

    Ring row i holds the latest position p <= pos with p % size == i, so a
    row's key position is ``pos - ((pos - i) % size)``, valid if it is in
    [0, pos] and within the window: the JAX ``attn_decode``'s rule, per
    row here where JAX vmaps a scalar ``pos``.

    With ``use_flash_attn`` and no window the attention is the K6 kernel
    (``flash_decode``) reading the cache in its stored layout.  An int8
    cache stores the new row quantised and attends over the dequantised
    cache in ``cfg.dtype`` (plain attention, as the JAX flash gate)."""
    b = x.shape[0]
    q, k1, v1 = _qkv(p, cfg, x, pos[:, None])
    size = cache["k"].shape[1]
    rows = torch.arange(b, device=x.device)
    p_ = pos.long()
    at = p_ % size if window is not None else p_.clamp(0, size - 1)
    if cfg.kv_cache_quant:
        for name, x1 in (("k", k1), ("v", v1)):
            q1, s1 = _quant_kv(x1[:, 0])
            cache[name][rows, at] = q1
            cache[name + "_s"][rows, at] = s1
        dt = torch_dtype(cfg.dtype)
        ck = (cache["k"].float() * cache["k_s"]).to(dt)
        cv = (cache["v"].float() * cache["v_s"]).to(dt)
    else:
        ck, cv = cache["k"], cache["v"]
        ck[rows, at] = k1[:, 0]
        cv[rows, at] = v1[:, 0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if _flash_ok(cfg, window, decode=True):
        o2 = flash_decode(q.reshape(b * h, hd), ck, cv, pos,
                          kv_groups=h // kvh)
        out = o2.reshape(b, 1, h, hd)
    else:
        idx = torch.arange(size, device=x.device)[None, :]
        p_ = p_[:, None]
        if window is None:
            valid = idx <= p_
        else:
            kpos = p_ - ((p_ - idx) % size)
            valid = (kpos <= p_) & (kpos >= 0) & (p_ - kpos < window)
        out = _sdpa(q, ck, cv, valid[:, None, :], cfg.logit_softcap, h, kvh,
                    f32_logits=cfg.attn_f32_logits)
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
