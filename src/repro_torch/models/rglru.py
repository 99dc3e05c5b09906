"""RG-LRU recurrent block of the port (RecurrentGemma / Griffin,
arXiv:2402.19427).

Port of ``src/repro/models/rglru.py``.  Two branches from the residual
stream, merged multiplicatively and projected out:

  gate branch : linear -> GeLU (tanh form, ``jax.nn.gelu``'s default)
  rec branch  : linear -> causal conv1d(4) -> RG-LRU

  r_t = σ(W_r u_t), i_t = σ(W_i u_t), a_t = σ(Λ)^(8 r_t)
  h_t = a_t ⊙ h_{t-1} + √(1 - a_t²) ⊙ (i_t ⊙ u_t)

Over a sequence the recurrence is the scan kernel
(``kernels/rglru_scan.py``; the JAX package uses
``jax.lax.associative_scan``); at decode it is one fused update per token.
The decode state is ``{"h": f32 [B, w], "conv": [B, 3, w]}`` and
:func:`rglru_decode` updates it IN PLACE, as the attention layers update
their KV caches.  :func:`rglru_prefill` computes the branch once and
returns the output with the state (the JAX package's
``_rglru_prefill_cache`` recomputes it; the values are the same).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.rglru_scan import rglru_scan
from .config import ModelConfig
from .layers import dense_init, torch_dtype

_C = 8.0
_MAX_SQRT = 1e-6


def rglru_init(g: torch.Generator, cfg: ModelConfig, device) -> Dict:
    """Random weights with the JAX package's keys, shapes, scales and
    dtypes; ``lam`` stays f32 in every model."""
    d = cfg.d_model
    w = cfg.lru_width or d
    dt = torch_dtype(cfg.dtype)
    # Λ so that a = σ(Λ)^c spans ~(0.9, 0.999), as in the paper
    lam = torch.log(torch.expm1(torch.linspace(2.0, 6.0, w,
                                               dtype=torch.float32,
                                               device=device)))
    conv = torch.randn((4, w), generator=g, device=device)
    return {
        "w_gate": dense_init(g, d, w, dt, device),
        "w_rec": dense_init(g, d, w, dt, device),
        "conv": conv.mul_(0.1).to(dt),
        "w_r": dense_init(g, w, w, dt, device),
        "w_i": dense_init(g, w, w, dt, device),
        "lam": lam,
        "w_out": dense_init(g, w, d, dt, device),
    }


def _conv4(x: torch.Tensor, w: torch.Tensor,
           prev: Optional[torch.Tensor] = None):
    """Causal depthwise conv of width ``k = w.shape[0]`` over axis 1.
    x [B, S, C], ``prev`` the last k-1 inputs before x (zeros if None) ->
    (out [B, S, C], the last k-1 inputs of ``[prev, x]``)."""
    k = w.shape[0]
    pad = prev if prev is not None else x.new_zeros(
        (x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return out, xp[:, -(k - 1):]


def _gates(p: Dict, u: torch.Tensor):
    """u [..., w], the conv output -> (a, β·i·u), both f32.  The products
    run in the weights' dtype and are cast to f32 after, as in JAX."""
    r = torch.sigmoid((u @ p["w_r"]).float())
    i = torch.sigmoid((u @ p["w_i"]).float())
    log_a = -_C * r * F.softplus(p["lam"])      # log σ(Λ)^(c·r), stable
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                      _MAX_SQRT))
    return a, beta * i * u.float()


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def rglru_prefill(p: Dict, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict]:
    """x [B, S, d] -> (y [B, S, d], decode state after the last position).
    The state is copied out of the sequence-long buffers, so they free."""
    gate = _gelu(x @ p["w_gate"])
    u, conv_state = _conv4(x @ p["w_rec"], p["conv"])
    a, bx = _gates(p, u)                               # [B, S, w], f32
    h = rglru_scan(a, bx)
    y = (h.to(x.dtype) * gate) @ p["w_out"]
    return y, {"h": h[:, -1].clone(), "conv": conv_state.clone()}


def rglru_train(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return rglru_prefill(p, cfg, x)[0]


def rglru_cache_init(cfg: ModelConfig, batch: int, device) -> Dict:
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, 3, w), dtype=torch_dtype(cfg.dtype),
                                device=device)}


def rglru_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 cache: Dict) -> torch.Tensor:
    """One token for B rows: x [B, 1, d] -> y [B, 1, d].  Every row's state
    in ``cache`` advances, in place."""
    gate = _gelu(x @ p["w_gate"])                      # [B, 1, w]
    u, conv_state = _conv4(x @ p["w_rec"], p["conv"], prev=cache["conv"])
    a, bx = _gates(p, u[:, 0])                         # [B, w]
    h = cache["h"] * a + bx
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_state)
    return (h[:, None].to(x.dtype) * gate) @ p["w_out"]
