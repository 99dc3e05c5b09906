"""Plain PyTorch references, in the JAX package's layouts and signatures
(``src/repro/kernels/ref.py``).

* The wire codecs' tile/block constants, ``_sparse_dims``, and the plain
  versions of K1–K4 (``quantize8_plain``, ``dequantize8_plain``,
  ``sparse_enc_plain``, ``sparse_dec_plain``).  They state the same
  contract as the ``*_xla`` functions of ``quant8.py``, ``sparse_enc.py``
  and ``sparse_dec.py``, bitwise; the kernel wrappers run them for CPU
  tensors, and ``chip_smoke.py`` holds the CUDA kernels to them.
* The plain version of the RG-LRU scan kernel (``rglru_scan_plain``), a
  step-by-step loop; the kernel is new in the port (the JAX package runs
  ``jax.lax.associative_scan``).
* The plain versions of the two SSD kernels of Mamba-2, also new in the
  port: ``ssd_state_scan_plain`` (the inter-chunk state recurrence, an
  ordered loop over chunks; the JAX package runs ``jax.lax.scan``) and
  ``ssd_decode_step_plain`` (one token's state update and readout, the
  reference's einsums in torch).
* The plain backward passes of the two scans (``rglru_scan_bwd_plain``,
  ``ssd_state_scan_bwd_plain``): explicit reverse loops with the backward
  kernels' arithmetic, where the JAX package differentiates
  ``associative_scan`` and ``lax.scan`` itself.
* The plain versions of the model step's norm and rotary kernels, S4
  (``norm_plain``) and S5 (``rotary_plain``): the expressions of
  ``models/layers.py``, which the JAX package writes the same way.
* Full-softmax attention (``attn_ref``, ``attn_decode_ref``): they
  materialize the whole score tensor in f32 — the thing the flash kernels
  exist to avoid — and serve as the oracles the flash kernels and their
  plain versions are held to.

Codec contract (shared by the plain versions and the kernels):

* quantize8: per (32, 128) tile, ``scale = amax * f32(1/127)`` (1.0 for an
  all-zero tile), ``q = round_half_even(x / scale)`` with an IEEE division.
  The reference writes ``amax / 127.0``, but XLA folds a division by a
  constant into a multiply by its f32 reciprocal, so that product is what
  the JAX package computes, on both its routes.
* sparse_enc (block-COO): each block of 512 keeps its first ``kb``
  elements with ``|x| > threshold`` (compared in f32), in position order,
  as (value in the source dtype, index from the frame's first element);
  empty slots are ``(0, block_base)``; ``cnt = min(nnz, kb)``, and on
  request the uncapped ``nnz`` itself.
* sparse_dec: scatter-add of every slot into a zeroed dense block.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30

QUANT_BM, QUANT_BN = 32, 128
SPARSE_B = 512  # elements per sparse block

#: f32(1/127), the reciprocal XLA multiplies by for ``amax / 127.0``
INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _sparse_dims(n: int, cap: int):
    nb = max(1, -(-n // SPARSE_B))
    kb = max(1, cap // nb)
    # the per-block capacity is rounded up to a multiple of 8 (the JAX
    # package's sublane alignment); the wire carries the logical kb
    kb = min(SPARSE_B, -(-kb // 8) * 8)
    return nb, kb


def _tiles(x: torch.Tensor) -> torch.Tensor:
    """[M, N] -> [gm, gn, BM, BN] tile view (M % BM == 0, N % BN == 0)."""
    m, n = x.shape
    return x.reshape(m // QUANT_BM, QUANT_BM, n // QUANT_BN,
                     QUANT_BN).permute(0, 2, 1, 3)


def _untile(t: torch.Tensor) -> torch.Tensor:
    gm, gn, bm, bn = t.shape
    return t.permute(0, 2, 1, 3).reshape(gm * bm, gn * bn)


def quantize8_plain(x: torch.Tensor):
    """x f32 [M, N] (M % 32 == N % 128 == 0) -> (q int8 [M, N], scales f32
    [M/32, N/128]): the tile view with ``amax``, as ``quantize8_xla``."""
    tiles = _tiles(x.to(torch.float32))
    amax = tiles.abs().amax(dim=(2, 3))
    scales = torch.where(amax > 0, amax * INV_127, torch.ones_like(amax))
    # tensor / tensor: a true division on the card too (a CPU-scalar
    # divisor would be turned into a multiply by its reciprocal there)
    q = torch.round(tiles / scales[:, :, None, None]).to(torch.int8)
    return _untile(q), scales


def dequantize8_plain(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 [M, N] + f32 [M/32, N/128] -> f32 [M, N]: ``q * scale``."""
    return _untile(_tiles(q).to(torch.float32) * scales[:, :, None, None])


def sparse_enc_plain(flat: torch.Tensor, kb: int, threshold: float = 0.0,
                     frame_blocks: Optional[int] = None,
                     totals: bool = False):
    """flat [nb*512] -> (values [nb*kb] in flat's dtype, indices int32
    [nb*kb], counts int32 [nb]): the rank search over ``cumsum(mask)`` of
    ``sparse_enc_xla`` — slot k of block r holds the (k+1)-th kept element,
    found by ``searchsorted(cumsum(mask[r]), k+1)``.  Indices count from
    the block's base within its frame of ``frame_blocks`` blocks (default:
    all of them, i.e. global indices); ``totals`` adds the uncapped counts
    of kept elements, int32 [nb]."""
    nb = flat.shape[0] // SPARSE_B
    fb = nb if frame_blocks is None else frame_blocks
    x2 = flat.reshape(nb, SPARSE_B)
    mask = x2.to(torch.float32).abs() > float(np.float32(threshold))
    csum = torch.cumsum(mask.to(torch.int32), dim=1).to(torch.int32)
    ks = torch.arange(1, kb + 1, dtype=torch.int32, device=flat.device)
    pos = torch.searchsorted(csum, ks.expand(nb, kb).contiguous(),
                             side="left")
    valid = pos < SPARSE_B
    posc = pos.clamp_max(SPARSE_B - 1)
    base = (torch.arange(nb, dtype=torch.int64, device=flat.device) % max(
        fb, 1) * SPARSE_B)[:, None]
    vals = torch.where(valid, torch.gather(x2, 1, posc),
                       torch.zeros((), dtype=flat.dtype, device=flat.device))
    idxs = torch.where(valid, base + posc, base).to(torch.int32)
    nnz = csum[:, -1].contiguous()
    out = (vals.reshape(-1), idxs.reshape(-1),
           nnz.clamp_max(kb).to(torch.int32))
    return out + (nnz,) if totals else out


def sparse_dec_plain(v2: torch.Tensor, i2: torch.Tensor) -> torch.Tensor:
    """values/indices [nb, kb] -> dense [nb*512] in the values' dtype: the
    scatter-add ``zeros().index_add_`` of ``sparse_dec_xla``."""
    nb = v2.shape[0]
    dense = torch.zeros(nb * SPARSE_B, dtype=v2.dtype, device=v2.device)
    return dense.index_add_(0, i2.reshape(-1).to(torch.int64),
                            v2.reshape(-1))


def attn_ref(q, k, v, *, causal: bool = True, kv_groups: int = 1):
    """q [BH, Sq, dk], k/v [BH//kv_groups, Sk, d*] -> [BH, Sq, dv]."""
    bh, sq, dk = q.shape
    if kv_groups > 1:
        k = k.repeat_interleave(kv_groups, dim=0)
        v = v.repeat_interleave(kv_groups, dim=0)
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * (dk ** -0.5)
    if causal:
        sk = k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, v.float()).to(q.dtype)


def attn_decode_ref(q, k, v, pos, *, kv_groups: int = 1):
    """q [BH, dk] (one query position), cached k/v [BKV, Sk, d*], ``pos``
    the last valid cache index -> [BH, dv]."""
    dk = q.shape[-1]
    if kv_groups > 1:
        k = k.repeat_interleave(kv_groups, dim=0)
        v = v.repeat_interleave(kv_groups, dim=0)
    s = torch.einsum("hd,hkd->hk", q.float(), k.float()) * (dk ** -0.5)
    sk = k.shape[1]
    valid = torch.arange(sk, device=q.device) <= int(pos)
    s = torch.where(valid[None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hk,hkd->hd", p, v.float()).to(q.dtype)


def rglru_scan_plain(a: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + bx_t over axis 1, h_{-1} = 0: a, bx f32
    [B, S, w] -> h f32 [B, S, w].  One multiply then one add per step, in
    sequence order: the kernel's arithmetic, and the decode step's."""
    h = torch.empty_like(bx)
    state = torch.zeros_like(bx[:, 0])
    for t in range(bx.shape[1]):
        state = a[:, t] * state + bx[:, t]
        h[:, t] = state
    return h


def rglru_scan_bwd_plain(a: torch.Tensor, h: torch.Tensor,
                         gh: torch.Tensor):
    """Backward of :func:`rglru_scan_plain`: a, h (its output) and gh, the
    gradient of h, f32 [B, S, w] -> (d_a, d_bx) f32 [B, S, w].  In reverse
    order from g_S = 0, g_t = gh_t + a_{t+1} g_{t+1} (a multiply then an
    add), d_bx_t = g_t and d_a_t = g_t h_{t-1} with h_{-1} = 0: the backward
    kernel's arithmetic, step for step."""
    d_a = torch.empty_like(a)
    d_bx = torch.empty_like(a)
    g = torch.zeros_like(a[:, 0])
    a_next = torch.zeros_like(a[:, 0])
    for t in reversed(range(a.shape[1])):
        g = a_next * g + gh[:, t]
        d_bx[:, t] = g
        d_a[:, t] = g * (h[:, t - 1] if t else torch.zeros_like(g))
        a_next = a[:, t]
    return d_a, d_bx


def ssd_state_scan_bwd_plain(decay: torch.Tensor, h_starts: torch.Tensor,
                             g_starts: Optional[torch.Tensor],
                             g_final: Optional[torch.Tensor],
                             with_h0: bool = False):
    """Backward of :func:`ssd_state_scan_plain`: decay f32 [B, nc, H]; its
    output h_starts f32 [B, nc, H, N, hd]; the gradients of h_starts and
    h_final (``None`` reads as zeros) -> (d_decay f32 [B, nc, H], d_states
    f32 [B, nc, H, N, hd], d_h0 f32 [B, H, N, hd] or None).  From gh_nc =
    g_final, in reverse chunk order: d_states_c = gh_{c+1}, d_decay_c =
    sum over (N, hd) of gh_{c+1} * h_c, gh_c = g_starts_c + decay_c *
    gh_{c+1} (a multiply then an add); d_h0 = gh_0 when ``with_h0``."""
    zeros = torch.zeros_like(h_starts[:, 0])
    gh = zeros if g_final is None else g_final
    d_states = torch.empty_like(h_starts)
    d_decay = torch.empty_like(decay)
    for c in reversed(range(h_starts.shape[1])):
        d_states[:, c] = gh
        d_decay[:, c] = (gh * h_starts[:, c]).sum(dim=(-2, -1))
        gs = zeros if g_starts is None else g_starts[:, c]
        gh = gs + decay[:, c, :, None, None] * gh
    return d_decay, d_states, (gh if with_h0 else None)


def ssd_state_scan_plain(decay: torch.Tensor, states: torch.Tensor,
                         h0: Optional[torch.Tensor] = None):
    """The SSD inter-chunk recurrence h_{c+1} = h_c * decay_c + S_c, in
    chunk order: decay f32 [B, nc, H], chunk states S_c f32 [B, nc, H, N,
    hd], h0 f32 [B, H, N, hd] (zeros if None) -> (h_starts f32 [B, nc, H,
    N, hd], the state entering each chunk; h_final f32 [B, H, N, hd]).  One
    multiply then one add per step: the kernel's arithmetic."""
    state = torch.zeros_like(states[:, 0]) if h0 is None else h0
    h_starts = torch.empty_like(states)
    for c in range(states.shape[1]):
        h_starts[:, c] = state
        state = state * decay[:, c, :, None, None] + states[:, c]
    return h_starts, state


def ssd_decode_step_plain(h: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                          B: torch.Tensor, C: torch.Tensor, x: torch.Tensor,
                          D: torch.Tensor,
                          active: Optional[torch.Tensor] = None):
    """One token of the SSD recurrence for every row: h f32 [B, H, N, hd];
    dt f32 [B, H] (softplus'd); A, D f32 [H] (A negative); B, C [B, N] and
    x [B, H * hd] in f32 or bf16 (widened here) ->
    (h' f32 [B, H, N, hd], y f32 [B, H, hd]) with

        h' = h * exp(dt A) + (dt B) x,   y = C . h' + D x.

    ``active`` (bool [B]): rows where it is False keep h (h' = h).  h' is
    a fresh tensor."""
    b, nh, n, hd = h.shape
    xh = x.float().reshape(b, nh, hd)
    dec = torch.exp(dt * A[None, :])                              # [B, H]
    upd = (dt[:, :, None] * B.float()[:, None, :])[..., None] * \
        xh[:, :, None, :]                                         # [B,H,N,hd]
    hnew = h * dec[:, :, None, None] + upd
    if active is not None:
        hnew = torch.where(active[:, None, None, None], hnew, h)
    y = torch.einsum("bn,bhnd->bhd", C.float(), hnew)
    return hnew, y + D[None, :, None] * xh


def norm_plain(x: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of S4: x [..., d] -> y in x's dtype, statistics in
    f32 with f32 ``scale`` (and ``bias``) [d]: RMSNorm (eps 1e-6) without
    ``bias``, LayerNorm (eps 1e-5) with it (``models/layers.py``
    ``apply_norm``'s expression, as the JAX package writes it)."""
    xf = x.float()
    if bias is not None:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5) * scale + bias
    else:
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)
        y = y * scale
    return y.to(x.dtype)


def rotary_plain(x: torch.Tensor, positions: torch.Tensor, rope_frac: float,
                 theta: float, freqs: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The plain version of S5: x [B, S, H, hd]; positions [B, S] absolute.
    Rotates the leading ``rope_frac`` of hd in interleaved pairs (partial
    rotary); ``models/layers.py``'s expression, as the JAX package writes
    it.  ``freqs`` (f32 [rot / 2]) replaces ``theta^(-2i / rot)``: YaRN's
    table (``models/mla.py``)."""
    hd = x.shape[-1]
    rot = int(hd * rope_frac) // 2 * 2
    if rot == 0:
        return x
    if freqs is None:
        exps = torch.arange(0, rot, 2, dtype=torch.float32,
                            device=x.device) / rot
        freqs = 1.0 / (theta ** exps)                              # [rot/2]
    ang = positions[..., None].float() * freqs                     # [B,S,r/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)
