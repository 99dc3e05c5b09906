"""Mamba-2 SSD block of the port (state-space duality, arXiv:2405.21060).

Port of ``src/repro/models/ssm.py``.  Chunked SSD: the sequence is split
into chunks of length Q; within a chunk the dual (attention-like)
quadratic form runs as matrix products, between chunks a linear state
recurrence runs (the port's kernel S2, ``kernels/ssd_scan.py``; the JAX
package uses ``jax.lax.scan``); at decode it is one fused update per token
(kernel S3, ``kernels/ssd_decode.py``).

    h_t = exp(A·dt_t) h_{t-1} + dt_t · B_t ⊗ x_t        (state [H, N, hd])
    y_t = C_t · h_t + D ⊙ x_t

The decode state is ``{"h": f32 [B, H, N, hd], "conv": [B, K-1, d_inner +
2N]}`` (``conv`` in ``cfg.dtype``).  :func:`ssm_decode` returns h' in a
fresh tensor and rebinds the cache's ``h`` leaf to it (a CUDA graph's
write-back copies it into the caller's leaf); ``conv`` is updated in place,
as the other layers update their caches.  Rows where ``active`` is False
keep both.  :func:`ssm_prefill` returns the output and the decode cache
from one SSD computation (the JAX package's ``_ssm_prefill_cache``
recomputes the same state).

Under a mesh with a ``model`` axis (the launchers install it as
``"__mesh__"`` in ``models.sharding``'s rules), a config with
``ssm_seq_parallel`` such as mamba2-130m runs the sequence-parallel SSD of
the JAX package (``ssm_train_seq_parallel``, ``_ssm_prefill_seq_parallel``):
the sequence splits over ``model`` and the batch over the data axes.  The
port runs the JAX package's ``shard_map`` body in phases split at its
collectives (``launch/spmd.py``): per slot the projection, the conv with
its left neighbour's K - 1 halo and the local chunk scan (S2, h0 = 0);
then the slots' (decay, state) pairs combine in a log-depth scan, in the
JAX package's pairing order (shift 1, 2, 4, ...); then per slot the
correction ``y += C exp(cum) h0``, the gate and ``w_out``.  Autograd runs
through all of it.  Without such a mesh, the single-device path.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.ssd_decode import ssd_decode_step
from ..kernels.ssd_scan import ssd_state_scan
from .config import ModelConfig
from .layers import dense_init, torch_dtype


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def ssm_init(g: torch.Generator, cfg: ModelConfig, device) -> Dict:
    """Random weights with the JAX package's keys, shapes, scales and
    dtypes (``A_log``, ``D`` and ``dt_bias`` f32, the rest ``cfg.dtype``);
    in_proj packs [z (gate), x, B, C, dt] as in mamba2."""
    d = cfg.d_model
    d_inner, h, hd, n = _dims(cfg)
    dt = torch_dtype(cfg.dtype)
    conv = torch.randn((cfg.ssm_conv, d_inner + 2 * n), generator=g,
                       device=device)
    return {
        "w_in": dense_init(g, d, 2 * d_inner + 2 * n + h, dt, device),
        "conv": conv.mul_(0.1).to(dt),
        "A_log": torch.zeros((h,), dtype=torch.float32, device=device),
        "D": torch.ones((h,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "w_out": dense_init(g, d_inner, d, dt, device),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    """-> (z, xbc, dt_raw) column views of in_proj's output."""
    d_inner, h, hd, n = _dims(cfg)
    return torch.split(proj, [d_inner, d_inner + 2 * n, h], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 prev: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d of window K, then SiLU.  xbc [B, S, C]; w
    [K, C]; ``prev`` [B, K-1, C] the carried state (zeros if None) ->
    (out [B, S, C], the last K-1 inputs of ``[prev, xbc]``).  The taps are
    summed in the reference's order, ((t0 + t1) + t2) + t3."""
    k = w.shape[0]
    pad = prev if prev is not None else xbc.new_zeros(
        (xbc.shape[0], k - 1, xbc.shape[2]))
    xp = torch.cat([pad, xbc], dim=1)                       # [B, S+K-1, C]
    out = sum(xp[:, i:i + xbc.shape[1]] * w[i] for i in range(k))
    return F.silu(out), xp[:, -(k - 1):]


def _ssd_scan(cfg: ModelConfig, p: Dict, xh, B, C, dt,
              h0: Optional[torch.Tensor] = None, with_cum: bool = False):
    """Chunked SSD scan.  xh [B, S, H, hd]; B, C [B, S, N]; dt f32 [B, S, H]
    (softplus'd) -> (y f32 [B, S, H, hd] with the D skip, final state f32
    [B, H, N, hd]).  The chunk is ``q = min(ssm_chunk, S)``; S is padded to
    a multiple of q with zero dt (decay 1, update 0: state and outputs
    exact).  ``with_cum`` adds the running log-decay from the sequence's
    start, f32 [B, S, H] (the per-chunk cumsum plus the exclusive chunk
    offset, as the JAX package computes it), which the sequence-parallel
    correction reads."""
    b, s, h, hd = xh.shape
    n = B.shape[-1]
    q = min(cfg.ssm_chunk, s)
    pad = (-s) % q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    s_orig, s = s, s + pad
    nc = s // q
    A = -torch.exp(p["A_log"])                              # [H], negative
    dA = dt * A                                             # [B, S, H]
    dA_c = dA.reshape(b, nc, q, h)
    xh_c = xh.reshape(b, nc, q, h, hd).float()
    B_c = B.reshape(b, nc, q, n).float()
    C_c = C.reshape(b, nc, q, n).float()
    dt_c = dt.reshape(b, nc, q, h)

    cum = torch.cumsum(dA_c, dim=2)                         # [B, nc, q, H]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # [B,nc,q,q,H]
    # exp of the causal entries only: the masked ones (i < j, seg > 0)
    # overflow to inf at a 128-token chunk, and where(causal, exp(seg), 0),
    # the JAX package's form, then back-propagates 0 * inf = NaN (its
    # gradients are NaN at mamba2-130m's chunk).  exp(-inf) = 0 gives the
    # same forward values, bitwise, and finite gradients.
    causal = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    L = torch.exp(torch.where(causal[None, None, :, :, None], seg,
                              torch.full((), -torch.inf, device=xh.device)))

    # intra-chunk (dual quadratic form): y_intra[i] = Σ_j L[i,j] (C_i·B_j)
    # dt_j x_j
    G = torch.einsum("bcin,bcjn->bcij", C_c, B_c)           # [B, nc, q, q]
    M = G[..., None] * L * dt_c[:, :, None, :, :]           # [B,nc,q,q,H]
    y_intra = torch.einsum("bcijh,bcjhd->bcihd", M, xh_c)

    # chunk-final states: S_c = Σ_j exp(cum_last - cum_j) dt_j B_j ⊗ x_j
    w = torch.exp(cum[:, :, -1:, :] - cum) * dt_c           # [B, nc, q, H]
    S_c = torch.einsum("bcjn,bcjhd->bchnd", B_c, xh_c * w[..., None])

    # inter-chunk recurrence over chunk states (kernel S2)
    chunk_decay = torch.exp(dA_c.sum(dim=2))                # [B, nc, H]
    h_starts, h_final = ssd_state_scan(chunk_decay, S_c.contiguous(), h0)

    # inter-chunk contribution: y_inter[i] = C_i · (decay_to_i * h_start)
    y_inter = torch.einsum("bcin,bchnd->bcihd", C_c, h_starts) * \
        torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(b, s, h, hd)
    y = y + p["D"][None, None, :, None] * xh.float()
    if not with_cum:
        return y[:, :s_orig], h_final
    chunk_sum = dA_c.sum(dim=2)                             # [B, nc, H]
    offs = torch.cumsum(chunk_sum, dim=1) - chunk_sum       # exclusive
    cum_total = (cum + offs[:, :, None, :]).reshape(b, s, h)
    return y[:, :s_orig], h_final, cum_total[:, :s_orig]


def _mixer_inputs(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                  prev: Optional[torch.Tensor] = None):
    """in_proj, the causal conv and dt -> (z, conv output xbc [B, S, C],
    the new conv state, dt f32 [B, S, H])."""
    proj = x @ p["w_in"]
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc, conv_state = _causal_conv(xbc, p["conv"], prev)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    return z, xbc, conv_state, dt


def _seq_parallel_mesh(cfg: ModelConfig, x: torch.Tensor):
    """The installed mesh when this call takes the sequence-parallel path:
    ``ssm_seq_parallel``, a ``model`` axis, and a sequence that tiles it
    (the JAX package's dispatch)."""
    if not cfg.ssm_seq_parallel:
        return None
    from .sharding import current_rules
    mesh = current_rules().get("__mesh__")
    if mesh is not None and "model" in getattr(mesh, "axis_names", ()) \
            and x.shape[1] % mesh.shape["model"] == 0:
        return mesh
    return None


def ssm_prefill(p: Dict, cfg: ModelConfig, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict]:
    """Single-pass prefill: x [B, S, d] -> (y [B, S, d], the decode cache:
    the final SSD state and the conv tail) from one SSD computation; the
    sequence-parallel path under a mesh (module docstring)."""
    mesh = _seq_parallel_mesh(cfg, x)
    if mesh is not None:
        return _ssm_prefill_seq_parallel(p, cfg, x, mesh)
    b, s, _ = x.shape
    d_inner, h, hd, n = _dims(cfg)
    z, xbc, conv_state, dt = _mixer_inputs(p, cfg, x)
    xs, B, C = torch.split(xbc, [d_inner, n, n], dim=-1)
    y, h_final = _ssd_scan(cfg, p, xs.reshape(b, s, h, hd), B, C, dt)
    y = (y.to(x.dtype).reshape(b, s, d_inner)) * F.silu(z)
    return y @ p["w_out"], {"h": h_final, "conv": conv_state.contiguous()}


def ssm_train(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    mesh = _seq_parallel_mesh(cfg, x)
    if mesh is not None:
        return ssm_train_seq_parallel(p, cfg, x, mesh)
    return ssm_prefill(p, cfg, x)[0]


# ---------------------------------------------------------------------------
# sequence-parallel SSD (the JAX package's shard_map path, in phases)
# ---------------------------------------------------------------------------
#
# SSD's inter-chunk recurrence is associative over (decay, state) pairs:
#   (D1, S1) o (D2, S2) = (D1 D2, S1 D2 + S2)
# so the slots' final states combine in log2(model) rounds; the conv needs
# a K - 1 frame halo from the left neighbour, and each position's output
# gains y += C_t exp(cum_t) h0.

def ssm_train_seq_parallel(p: Dict, cfg: ModelConfig, x: torch.Tensor, mesh
                           ) -> torch.Tensor:
    return _ssm_prefill_seq_parallel(p, cfg, x, mesh, with_cache=False)[0]


def _ssm_prefill_seq_parallel(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                              mesh, with_cache: bool = True
                              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x [B, S, d] -> (y [B, S, d], cache) with S split over ``model`` and
    B over the data axes (replicated when B does not tile them).  The
    cache is the last model slot's inclusive state and conv tail, which
    every model slot gets (the JAX package's masked ``psum``; the conv
    tail summed in f32); ``with_cache=False`` (training) makes none."""
    from ..launch.mesh import P, data_axes
    from ..launch.spmd import (axis_index, broadcast_from, gather, ppermute,
                               slot_map, split)
    b, s, _ = x.shape
    d_inner, h, hd, n = _dims(cfg)
    m = mesh.shape["model"]
    dp = data_axes(mesh)
    dsize = 1
    for a in dp:
        dsize *= mesh.shape[a]
    if b % max(dsize, 1):
        dp = ()
    bspec = dp if len(dp) > 1 else (dp[0] if dp else None)
    perm_fwd = [(i, i + 1) for i in range(m - 1)]
    k = p["conv"].shape[0]
    A = -torch.exp(p["A_log"])
    names = ("w_in", "conv", "A_log", "D", "dt_bias", "w_out")
    pp = {nm: split(p[nm], mesh, P()) for nm in names}

    def slot_params(idx):
        return {nm: pp[nm][idx] for nm in names}

    xs = split(x, mesh, P(bspec, "model", None))
    idxs = np.empty(mesh.devices.shape, dtype=object)
    for idx in np.ndindex(idxs.shape):
        idxs[idx] = idx

    # phase 1: projection; the conv halo goes to the right neighbour
    def proj(xl, idx):
        z, xbc, dt_raw = _split_proj(cfg, xl @ pp["w_in"][idx])
        return z, xbc, dt_raw, xbc[:, -(k - 1):]
    z, xbc, dt_raw, tail = slot_map(proj, mesh, xs, idxs, n_out=4)
    prev = ppermute(tail, mesh, "model", perm_fwd)

    # phase 2: the conv and the local chunk scan from h0 = 0
    def local(xbc_l, prev_l, dt_raw_l, idx):
        lp = slot_params(idx)
        bl, sl, _ = xbc_l.shape
        xbc_c, conv_tail = _causal_conv(xbc_l, lp["conv"], prev_l)
        xs_l, B, C = torch.split(xbc_c, [d_inner, n, n], dim=-1)
        dt = F.softplus(dt_raw_l.float() + lp["dt_bias"])
        y0, h_loc, cum = _ssd_scan(cfg, lp, xs_l.reshape(bl, sl, h, hd), B,
                                   C, dt, None, with_cum=True)
        d_loc = torch.exp(torch.sum(dt * A.to(dt.device), dim=1))  # [B, H]
        return y0, h_loc, cum, C, conv_tail, d_loc
    y0, h_loc, cum, C, conv_tail, d_acc = slot_map(
        local, mesh, xbc, prev, dt_raw, idxs, n_out=6)

    # the cross-slot inclusive scan of (decay product, state)
    s_acc = h_loc
    pos = axis_index(mesh, "model")
    shift = 1
    while shift < m:
        pairs = [(i, i + shift) for i in range(m - shift)]
        # the last round's decay product is dead, so its permute is not
        # made (XLA drops it from the JAX package's program too)
        d_in = d_acc if 2 * shift >= m else \
            ppermute(d_acc, mesh, "model", pairs)
        s_in = ppermute(s_acc, mesh, "model", pairs)

        def combine(d_in_l, s_in_l, d_l, s_l, pos_l, _shift=shift):
            has_left = 1.0 if pos_l >= _shift else 0.0
            d_new = d_in_l * d_l if has_left else d_l
            s_new = s_in_l * d_l[:, :, None, None] * has_left + s_l
            return d_new, s_new
        d_acc, s_acc = slot_map(combine, mesh, d_in, s_in, d_acc, s_acc,
                                pos, n_out=2)
        shift *= 2
    # exclusive prefix: the left neighbour's inclusive state (0 at slot 0)
    h0 = ppermute(s_acc, mesh, "model", perm_fwd)

    # phase 3: the correction, the gate and the output projection
    def finish(y0_l, C_l, cum_l, h0_l, z_l, idx):
        bl, sl = y0_l.shape[:2]
        y_corr = torch.einsum("bsn,bsh,bhnd->bshd", C_l.float(),
                              torch.exp(cum_l), h0_l)
        y = (y0_l + y_corr).to(x.dtype).reshape(bl, sl, d_inner)
        return (y * F.silu(z_l)) @ pp["w_out"][idx]
    out = slot_map(finish, mesh, y0, C, cum, h0, z, idxs)

    home = x.device
    y = gather(out, mesh, P(bspec, "model", None), home)
    if not with_cache:
        return y, None
    last = broadcast_from(s_acc, mesh, "model", m - 1)
    last_conv = broadcast_from(conv_tail, mesh, "model", m - 1,
                               wire_dtype=torch.float32)
    cache = {"h": gather(last, mesh, P(bspec, None, None, None), home),
             "conv": gather(last_conv, mesh, P(bspec, None, None),
                            home).contiguous()}
    return y, cache


def ssm_cache_init(cfg: ModelConfig, batch: int, device) -> Dict:
    d_inner, h, hd, n = _dims(cfg)
    return {"h": torch.zeros((batch, h, n, hd), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * n),
                                dtype=torch_dtype(cfg.dtype), device=device)}


def ssm_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
               active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token for B rows: x [B, 1, d] -> y [B, 1, d].  The state update
    and readout are kernel S3; the cache's ``h`` is rebound to the fresh
    h', ``conv`` updated in place.  ``active`` (bool [B]): rows where it is
    False keep their state."""
    b = x.shape[0]
    d_inner, h, hd, n = _dims(cfg)
    z, xbc, conv_state, dt = _mixer_inputs(p, cfg, x, cache["conv"])
    row = xbc[:, 0]                                         # [B, C]
    hnew, y = ssd_decode_step(cache["h"], dt[:, 0], -torch.exp(p["A_log"]),
                              row[:, d_inner:d_inner + n],
                              row[:, d_inner + n:], row[:, :d_inner],
                              p["D"], active)
    if active is not None:
        conv_state = torch.where(active[:, None, None], conv_state,
                                 cache["conv"])
    cache["conv"].copy_(conv_state)
    cache["h"] = hnew
    y = y.reshape(b, 1, d_inner).to(x.dtype) * F.silu(z)
    return y @ p["w_out"]
