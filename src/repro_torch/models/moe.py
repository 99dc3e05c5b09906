"""Mixture-of-Experts layer of the port: top-k router, capacity-bounded
sort+gather dispatch, shared experts (DeepSeek-V2).

Port of the single-device path of ``src/repro/models/moe.py``
(``_apply_moe_dense``); the expert-parallel shard_map path waits for the
mesh (ROADMAP M11).  The expert products are plain ``torch.bmm`` over
``[E, C, d]`` gathers, as the JAX package leaves them to XLA.

Three places where the port must say exactly what the reference does:

* **Ties.**  ``lax.top_k`` takes the lower expert index on equal
  probabilities and ``jnp.argsort`` is stable: the router picks with a
  stable descending sort sliced to k, and the dispatch order is a stable
  argsort of the flat expert ids.
* **The combine.**  ``y.at[tok].add(contrib)`` becomes, for each token,
  its k contributions added one by one in ascending expert order (the
  order in which the JAX scatter meets them), never ``index_add_``: its
  float atomics on the card would reorder the adds from run to run.
* **Capacity on the serve path.**  The JAX serve element vmaps a b = 1
  decode over its slots, so each slot's tokens fill their own
  ``max(1, int(T·k/E·cf))`` expert slots.  ``apply_moe(..., per_row=True)``
  groups the dispatch by batch row to give the port's batch-S decode step
  the same capacity (a stream never loses a slot to its neighbours); the
  default pools all B·S tokens, as ``lm_decode`` at batch B does in the
  reference.

:func:`drop_log` collects, for every call in its block, ``(per_row,
tokens, dropped)``: ``dropped`` the count of (token, expert) choices that
capacity turned away, as a device tensor (no host read inside the layer).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

from .config import ModelConfig
from .layers import _act, dense_init, torch_dtype

#: the list of the innermost :func:`drop_log` block, else ``None``
DROP_LOG: Optional[List] = None


@contextlib.contextmanager
def drop_log():
    """``with drop_log() as log:`` — every :func:`apply_moe` call in the
    block appends ``(per_row, T, dropped)`` to ``log``.  Not for a block
    that captures a CUDA graph (a replay would not append)."""
    global DROP_LOG
    prev, DROP_LOG = DROP_LOG, []
    try:
        yield DROP_LOG
    finally:
        DROP_LOG = prev


def _expert_weights(g, e: int, d_in: int, d_out: int, dt, device):
    """[E, d_in, d_out] at scale d_in^-0.5, drawn one expert at a time (one
    expert's f32 draw lives at a time, not all E)."""
    w = torch.empty((e, d_in, d_out), dtype=dt, device=device)
    for i in range(e):
        x = torch.randn((d_in, d_out), generator=g, device=device)
        w[i].copy_(x.mul_(d_in ** -0.5))
    return w


def moe_init(g: torch.Generator, cfg: ModelConfig, device) -> Dict:
    """Router (f32, scale 0.02), experts ``w_up``/``w_gate`` [E, d, f] and
    ``w_down`` [E, f, d] in ``cfg.dtype``, and ``shared`` experts as one
    gated MLP of width f·n_shared."""
    d, f, e = cfg.d_model, cfg.d_ff_expert or cfg.d_ff, cfg.n_experts
    dt = torch_dtype(cfg.dtype)
    p = {"router": dense_init(g, d, e, torch.float32, device, scale=0.02),
         "w_up": _expert_weights(g, e, d, f, dt, device),
         "w_gate": _expert_weights(g, e, d, f, dt, device),
         "w_down": _expert_weights(g, e, f, d, dt, device)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"w_up": dense_init(g, d, fs, dt, device),
                       "w_gate": dense_init(g, d, fs, dt, device),
                       "w_down": dense_init(g, fs, d, dt, device)}
    return p


def top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last dim, the lower index
    first among equals (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Expert slots of one dispatch group of ``tokens`` tokens."""
    return max(1, int(tokens * cfg.top_k / cfg.n_experts *
                      cfg.capacity_factor))


def apply_moe(p: Dict, cfg: ModelConfig, x: torch.Tensor,
              per_row: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux f32 scalar).  One dispatch group
    of all B·S tokens, or with ``per_row`` one group per batch row (S
    tokens each, capacity from S).  ``aux`` is the Switch load-balance
    loss over all tokens."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    xg = x.reshape(1, b * s, d) if not per_row else x
    n_g, t = xg.shape[:2]
    dev = x.device

    logits = xg.float() @ p["router"]                       # [G, T, E]
    probs = torch.softmax(logits, dim=-1)
    topw, topi = top_k(probs, k)                            # [G, T, k]
    topw = topw / topw.sum(-1, keepdim=True)

    # load-balance aux (Switch): E * sum_e fraction_e * prob_e
    experts = torch.arange(e, device=dev)
    hits = (topi[..., None] == experts).float().sum(-2)     # [G, T, E]
    frac = hits.reshape(-1, e).mean(0)
    pmean = probs.reshape(-1, e).mean(0)
    aux = e * torch.sum(frac / k * pmean) * cfg.router_aux_weight

    # sort+gather dispatch, per group
    cap = capacity(t, cfg)
    flat_e = topi.reshape(n_g, t * k)                       # [G, T*k]
    order = torch.argsort(flat_e, dim=-1, stable=True)
    counts = torch.zeros((n_g, e), dtype=torch.long, device=dev)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, -1) - counts             # [G, E]
    lanes = torch.arange(cap, device=dev)
    slot_pos = (offsets[..., None] + lanes).clamp(0, t * k - 1)
    valid = lanes < counts[..., None]                       # [G, E, C]
    slot = torch.gather(order, 1, slot_pos.reshape(n_g, e * cap))
    tok = (slot // k).reshape(n_g, e, cap)                  # [G, E, C]
    rows = torch.arange(n_g, device=dev)[:, None, None]
    xe = xg[rows, tok] * valid[..., None].to(x.dtype)       # [G, E, C, d]
    xe = xe.transpose(0, 1).reshape(e, n_g * cap, d)
    gate = _act(cfg, torch.bmm(xe, p["w_gate"]))
    up = torch.bmm(xe, p["w_up"])
    ye = torch.bmm(gate * up, p["w_down"])                  # [E, G*C, d]
    ye = ye.reshape(e, n_g, cap, d).transpose(0, 1)         # [G, E, C, d]

    # combine: each token's k contributions in ascending expert order
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(t * k, device=dev)
                  .expand(n_g, t * k).contiguous())
    ex, pick = topi.sort(dim=-1)                            # [G, T, k]
    w = torch.gather(topw, -1, pick)
    r = torch.gather(rank.reshape(n_g, t, k), -1, pick) - \
        torch.gather(offsets, 1, ex.reshape(n_g, t * k)).reshape(n_g, t, k)
    kept = r < cap
    contrib = ye[rows, ex, r.clamp_max(cap - 1)].float() * \
        (w * kept)[..., None]                               # [G, T, k, d]
    y = torch.zeros((n_g, t, d), dtype=torch.float32, device=dev)
    for j in range(k):
        y = y + contrib[:, :, j]
    if DROP_LOG is not None:
        DROP_LOG.append((per_row, t, (~kept).sum()))

    if "shared" in p:
        sp = p["shared"]
        xt = xg.reshape(n_g * t, d)
        up_s = xt @ sp["w_up"]
        gate_s = _act(cfg, xt @ sp["w_gate"])
        y = y + ((gate_s * up_s) @ sp["w_down"]).float().reshape(n_g, t, d)
    return y.to(x.dtype).reshape(b, s, d), aux
