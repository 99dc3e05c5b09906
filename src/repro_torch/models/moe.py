"""Mixture-of-Experts layer of the port: top-k router, capacity-bounded
sort+gather dispatch, shared experts (DeepSeek-V2).

Port of ``src/repro/models/moe.py``: the single-device path
(``_apply_moe_dense``) and, under a mesh with a ``model`` axis (installed
as ``"__mesh__"`` in ``models.sharding``'s rules), the expert-parallel one
(``_apply_moe_shard_map``).  The expert products are plain ``torch.bmm``
over ``[E, C, d]`` gathers, as the JAX package leaves them to XLA.

The mesh path keeps tokens slot-local and moves none: the batch splits
over the data axes; the experts split over ``model``, whole experts when E
% model == 0 and not ``moe_force_tp`` (expert parallelism), else the
expert hidden dim f (intra-expert TP).  Each slot routes its tokens,
dispatches those of its own experts and adds their weighted outputs per
token in ascending expert order; the slots' partials add in slot order
(``launch.spmd.psum``, in bf16 under ``moe_psum_bf16``), ``aux`` is the
mean over the data slots, and the shared experts are added after the
cast to the activations' dtype, as in the JAX package.  The serve path's
``per_row=True`` always takes the single-device path.

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
tokens, dropped)``: ``dropped`` the count of (token, held expert) choices
that capacity turned away, as a device tensor (no host read inside the
layer).  :func:`count_into` writes the same counts, and the (token, held
expert) pairs, into a buffer on the device: the serve path's counters
(``core/modelserve.py``, read while the tracer of ``core/trace.py`` is on).

**One rank's share and DeepSeek-V2's router** (``ModelConfig`` fields the
JAX package lacks; at their defaults the layer is the JAX package's).  The
router scores all ``n_experts``; the layer holds ``experts_held`` of them
(``cfg.held_experts``) from ``expert_first`` on, and computes the part of
the result that its held experts give for the tokens routed to them, plus
the shared experts once: one rank of an expert-parallel deployment, with
no exchange and nothing standing in for the absent experts.  Counts,
offsets and capacity are indexed by the global expert id.  With
``n_group`` the router is DeepSeek-V2's ``group_limited_greedy``
(:func:`group_top_k`: a group scores its best expert, the best
``topk_group`` groups are kept, the top k is taken among their experts);
``norm_topk`` False leaves the top-k softmax scores unnormalised, and
``routed_scale`` multiplies them (DeepSeek-V2: 16).

**Capacity** is ``int(T·k/E·capacity_factor)`` slots an expert for a
group of T tokens, and never more than T: an expert meets a token at most
once, so slots past T could only be padding.  ``capacity_factor = E / k``
is therefore dropless: no choice is turned away (DeepSeek-V2's serve
preset).  The prefill pools its prompt into one group of L tokens and so
computes each held expert on L rows, most of them padding; the serve
tick's per-row groups of one token have capacity 1.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

from .config import ModelConfig
from .layers import _act, dense_init, torch_dtype

#: the list of the innermost :func:`drop_log` block, else ``None``
DROP_LOG: Optional[List] = None
#: the buffer and next row of the innermost :func:`count_into` block, else
#: ``None``
COUNTS: Optional[List] = None


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


@contextlib.contextmanager
def count_into(out: Optional[torch.Tensor]):
    """``with count_into(buf):`` — the j-th :func:`apply_moe` call in the
    block writes ``(tokens, pairs, dropped)`` into ``buf[j]`` (int64 [n, 3]
    on the layers' device), in place and with no host read: its tokens, its
    (token, held expert) choices and those of them that capacity turned
    away.  A CUDA graph captures the writes, so each replay refills the
    buffer.  ``out`` None counts nothing."""
    global COUNTS
    prev, COUNTS = COUNTS, (None if out is None else [out, 0])
    try:
        yield
    finally:
        COUNTS = prev


def _expert_weights(g, e: int, d_in: int, d_out: int, dt, device):
    """[E, d_in, d_out] at scale d_in^-0.5, drawn one expert at a time (one
    expert's f32 draw lives at a time, not all E)."""
    w = torch.empty((e, d_in, d_out), dtype=dt, device=device)
    for i in range(e):
        x = torch.randn((d_in, d_out), generator=g, device=device)
        w[i].copy_(x.mul_(d_in ** -0.5))
    return w


def moe_init(g: torch.Generator, cfg: ModelConfig, device) -> Dict:
    """Router (f32, scale 0.02) over all E experts, the held experts'
    ``w_up``/``w_gate`` [E_held, d, f] and ``w_down`` [E_held, f, d] in
    ``cfg.dtype``, and ``shared`` experts as one gated MLP of width
    f·n_shared."""
    d, f, e = cfg.d_model, cfg.d_ff_expert or cfg.d_ff, cfg.n_experts
    held = cfg.held_experts
    dt = torch_dtype(cfg.dtype)
    p = {"router": dense_init(g, d, e, torch.float32, device, scale=0.02),
         "w_up": _expert_weights(g, held, d, f, dt, device),
         "w_gate": _expert_weights(g, held, d, f, dt, device),
         "w_down": _expert_weights(g, held, f, d, dt, device)}
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


def group_top_k(probs: torch.Tensor, cfg: ModelConfig):
    """DeepSeek-V2's ``group_limited_greedy`` over probs [..., E]: the E
    experts in ``n_group`` consecutive groups, a group scored by its best
    expert, the ``topk_group`` best groups kept (:func:`top_k`), and the
    top k among the kept groups' experts (the others' scores set to 0, as
    Hugging Face's ``masked_fill``)."""
    e, n_g = cfg.n_experts, cfg.n_group
    grouped = probs.reshape(*probs.shape[:-1], n_g, e // n_g)
    _, keep = top_k(grouped.amax(-1), cfg.topk_group)
    mask = torch.zeros(probs.shape[:-1] + (n_g,), dtype=torch.bool,
                       device=probs.device)
    mask.scatter_(-1, keep, True)
    kept = grouped.masked_fill(~mask[..., None], 0.0).reshape(probs.shape)
    return top_k(kept, cfg.top_k)


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Expert slots of one dispatch group of ``tokens`` tokens, at most
    ``tokens`` (module docstring)."""
    return max(1, min(tokens, int(tokens * cfg.top_k / cfg.n_experts *
                                  cfg.capacity_factor)))


def apply_moe(p: Dict, cfg: ModelConfig, x: torch.Tensor,
              per_row: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux f32 scalar).  One dispatch group
    of all B·S tokens, or with ``per_row`` one group per batch row (S
    tokens each, capacity from S).  ``aux`` is the Switch load-balance
    loss over all tokens.  Under a mesh with a ``model`` axis (and not
    ``per_row``), the expert-parallel path (module docstring)."""
    if not per_row:
        from .sharding import current_rules
        mesh = current_rules().get("__mesh__")
        if mesh is not None and "model" in getattr(mesh, "axis_names", ()):
            return _apply_moe_shard_map(p, cfg, x, mesh)
    return _apply_moe_dense(p, cfg, x, per_row)


def _route(cfg: ModelConfig, xg: torch.Tensor, router: torch.Tensor):
    """Router, top-k (group-limited under ``n_group``) and the Switch aux
    over groups xg [G, T, d] -> (topw, topi [G, T, k], aux)."""
    e, k = cfg.n_experts, cfg.top_k
    logits = xg.float() @ router                            # [G, T, E]
    probs = torch.softmax(logits, dim=-1)
    topw, topi = group_top_k(probs, cfg) if cfg.n_group else \
        top_k(probs, k)                                     # [G, T, k]
    if cfg.norm_topk:
        topw = topw / topw.sum(-1, keepdim=True)
    if cfg.routed_scale != 1.0:
        topw = topw * cfg.routed_scale
    # load-balance aux (Switch): E * sum_e fraction_e * prob_e
    experts = torch.arange(e, device=xg.device)
    hits = (topi[..., None] == experts).float().sum(-2)     # [G, T, E]
    frac = hits.reshape(-1, e).mean(0)
    pmean = probs.reshape(-1, e).mean(0)
    aux = e * torch.sum(frac / k * pmean) * cfg.router_aux_weight
    return topw, topi, aux


def _dispatch(cfg: ModelConfig, xg, topw, topi, w_gate, w_up, w_down,
              first: int = 0, acc=torch.float32):
    """Sort+gather dispatch of groups xg [G, T, d] to the experts
    ``first .. first + E_loc`` whose weights are given, capacity per
    group, and the combine: each token's contributions from these experts
    added in ascending expert order onto zeros of ``acc`` -> (y [G, T, d]
    in ``acc``, kept [G, T, k]: the choices that found a slot, mine [G, T,
    k]: the choices of these experts)."""
    e, k = cfg.n_experts, cfg.top_k
    e_loc = w_up.shape[0]
    n_g, t, d = xg.shape
    dev = xg.device
    cap = capacity(t, cfg)
    flat_e = topi.reshape(n_g, t * k)                       # [G, T*k]
    order = torch.argsort(flat_e, dim=-1, stable=True)
    counts = torch.zeros((n_g, e), dtype=torch.long, device=dev)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, -1) - counts             # [G, E]
    lanes = torch.arange(cap, device=dev)
    off_l = offsets[:, first:first + e_loc]
    slot_pos = (off_l[..., None] + lanes).clamp(0, t * k - 1)
    valid = lanes < counts[:, first:first + e_loc, None]    # [G, E_loc, C]
    slot = torch.gather(order, 1, slot_pos.reshape(n_g, e_loc * cap))
    tok = (slot // k).reshape(n_g, e_loc, cap)              # [G, E_loc, C]
    rows = torch.arange(n_g, device=dev)[:, None, None]
    xe = xg[rows, tok] * valid[..., None].to(xg.dtype)      # [G,E_loc,C,d]
    xe = xe.transpose(0, 1).reshape(e_loc, n_g * cap, d)
    gate = _act(cfg, torch.bmm(xe, w_gate))
    up = torch.bmm(xe, w_up)
    ye = torch.bmm(gate * up, w_down)                       # [E_loc, G*C, d]
    ye = ye.reshape(e_loc, n_g, cap, d).transpose(0, 1)     # [G,E_loc,C,d]

    # combine: each token's contributions in ascending expert order
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(t * k, device=dev)
                  .expand(n_g, t * k).contiguous())
    ex, pick = topi.sort(dim=-1)                            # [G, T, k]
    w = torch.gather(topw, -1, pick)
    r = torch.gather(rank.reshape(n_g, t, k), -1, pick) - \
        torch.gather(offsets, 1, ex.reshape(n_g, t * k)).reshape(n_g, t, k)
    kept = r < cap
    mine = (ex >= first) & (ex < first + e_loc)
    el = (ex - first).clamp(0, e_loc - 1)
    contrib = ye[rows, el, r.clamp_max(cap - 1)].to(acc) * \
        (w * (kept & mine))[..., None].to(acc)              # [G, T, k, d]
    y = torch.zeros((n_g, t, d), dtype=acc, device=dev)
    for j in range(k):
        y = y + contrib[:, :, j]
    return y, kept, mine


def _apply_moe_dense(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                     per_row: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    xg = x.reshape(1, b * s, d) if not per_row else x
    n_g, t = xg.shape[:2]
    topw, topi, aux = _route(cfg, xg, p["router"])
    y, kept, mine = _dispatch(cfg, xg, topw, topi, p["w_gate"], p["w_up"],
                              p["w_down"], cfg.expert_first)
    if DROP_LOG is not None:
        DROP_LOG.append((per_row, t, (mine & ~kept).sum()))
    if COUNTS is not None:
        out, j = COUNTS
        COUNTS[1] = j + 1
        out[j, 0].fill_(n_g * t)
        out[j, 1:].copy_(torch.stack((mine, mine & ~kept)).sum((1, 2, 3)))

    if "shared" in p:
        sp = p["shared"]
        xt = xg.reshape(n_g * t, d)
        up_s = xt @ sp["w_up"]
        gate_s = _act(cfg, xt @ sp["w_gate"])
        y = y + ((gate_s * up_s) @ sp["w_down"]).float().reshape(n_g, t, d)
    return y.to(x.dtype).reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# the expert-parallel path (the JAX package's shard_map, in phases)
# ---------------------------------------------------------------------------

def _moe_specs(cfg: ModelConfig, mesh, batch: int):
    """-> (expert parallel?, the batch's spec entry, the specs of w_up,
    w_gate, w_down)."""
    from ..launch.mesh import P
    ep = (cfg.n_experts % mesh.shape["model"] == 0) and not cfg.moe_force_tp
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    dsize = 1
    for a in dp:
        dsize *= mesh.shape[a]
    if batch % max(dsize, 1):
        dp = ()                 # batch=1 decode: tokens replicated
    bspec = dp if len(dp) > 1 else (dp[0] if dp else None)
    if ep:
        w_up = w_gate = w_down = P("model", None, None)
    else:
        w_up = w_gate = P(None, None, "model")
        w_down = P(None, "model", None)
    return ep, bspec, (w_up, w_gate, w_down)


def _apply_moe_shard_map(p: Dict, cfg: ModelConfig, x: torch.Tensor, mesh
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux) over the mesh: one phase per slot
    (route its tokens, dispatch to its experts or its slice of f), then
    ``psum`` of the partials over ``model`` and ``pmean`` of aux over the
    data axes."""
    from ..launch.mesh import P
    from ..launch.spmd import axis_index, gather, pmean, psum, slot_map, \
        split
    b, s, d = x.shape
    e = cfg.n_experts
    ep, bspec, (s_up, s_gate, s_down) = _moe_specs(cfg, mesh, b)
    # aux varies over the data axes (different tokens); x is replicated
    # over model, so it is the same there
    dp_axes = bspec if isinstance(bspec, tuple) else \
        ((bspec,) if bspec else ())
    acc = torch.bfloat16 if cfg.moe_psum_bf16 else torch.float32
    xs = split(x, mesh, P(bspec, None, None))
    router = split(p["router"], mesh, P())
    wg = split(p["w_gate"], mesh, s_gate)
    wu = split(p["w_up"], mesh, s_up)
    wd = split(p["w_down"], mesh, s_down)
    pos = axis_index(mesh, "model")

    def local(xl, router_l, wg_l, wu_l, wd_l, pos_l):
        bl, sl, _ = xl.shape
        xg = xl.reshape(1, bl * sl, d)
        topw, topi, aux = _route(cfg, xg, router_l)
        e_loc = wu_l.shape[0]
        first = pos_l * e_loc if e_loc < e else 0
        y, _, _ = _dispatch(cfg, xg, topw, topi, wg_l, wu_l, wd_l, first,
                            acc)
        return y.reshape(bl * sl, d), aux
    y, aux = slot_map(local, mesh, xs, router, wg, wu, wd, pos, n_out=2)
    if dp_axes:
        aux = pmean(aux, mesh, dp_axes)
    y = psum(y, mesh, "model")

    def cast(y_l, xl):
        return y_l.to(xl.dtype).reshape(xl.shape)
    y = gather(slot_map(cast, mesh, y, xs), mesh, P(bspec, None, None),
               x.device)
    aux = aux[(0,) * aux.ndim].to(x.device)
    if "shared" in p:
        sp = p["shared"]
        xt = x.reshape(-1, d)
        up_s = xt @ sp["w_up"]
        gate_s = _act(cfg, xt @ sp["w_gate"])
        y = y + ((gate_s * up_s) @ sp["w_down"]).reshape(b, s, d)
    return y, aux
