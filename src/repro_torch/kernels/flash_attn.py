"""Flash attention for the serve path: prefill (K5) and the decode step (K6).

Ports of ``flash_attention`` and ``flash_decode_step`` in
``src/repro/kernels/flash_attn.py``.  Each public function is a wrapper that
dispatches on the tensors' device:

* a CPU tensor runs the function's plain PyTorch version in this module
  (the same blocked online-softmax arithmetic, in f32);
* a CUDA tensor runs the hand-written Hopper kernel in ``csrc/`` — built at
  first use, see ``build.py`` — or raises.  There is no fallback from the
  card to the plain version.

K5 has two routes on the card (:func:`prefill_route`): bfloat16 runs the
tensor-core kernel ``flash_prefill_sm90.cu`` (wgmma + TMA), float32 the
register-tiled SIMT kernel ``flash_prefill.cu`` (IEEE f32 FMAs on the CUDA
cores; its route keeps the name ``"scalar"``).  K6 is split-KV in
``flash_decode.cu`` (a partial pass and a combine pass) for both dtypes.
Every kernel takes head dims 64, 128 and 256 (``KERNEL_HEAD_DIMS``, dk ==
dv) and any ``kv_groups`` that divides the heads.

``LAUNCHES`` counts kernel launches per wrapper (plain-version calls do not
count), so a run can show that its path went through the kernels;
``PREFILL_ROUTE_LAUNCHES`` splits K5's count by route.

Neither kernel has a backward.  K6 raises on the card when an input
requires grad (``build.refuse_grad``); K5 raises on both routes, because
the JAX package's ``flash_attention`` cannot be differentiated either
(``jax.grad`` through its ``pallas_call`` fails), so no configuration
trains with ``use_flash_attn``.

What bounds each kernel on an H100 and what its design does about it is
written at the top of its CUDA source.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .build import (DTYPE_CODE, dtype_code, entry as _lib,
                    raise_on as _raise_on, refuse_grad, route as _route)
from .ref import NEG_INF

__all__ = ["flash_attention", "flash_attention_plain", "flash_decode",
           "flash_decode_plain", "LAUNCHES", "PREFILL_ROUTE_LAUNCHES",
           "HEAD_DIM_LAUNCHES",
           "reset_launches", "KERNEL_HEAD_DIMS", "prefill_route",
           "tma_aligned", "decode_splits", "decode_scratch_shape"]

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_decode": 0}
#: K5's launches by route (:func:`prefill_route`), counted with LAUNCHES
PREFILL_ROUTE_LAUNCHES: Dict[str, int] = {"sm90": 0, "scalar": 0}

#: the head dims the CUDA kernels are instantiated for (dk == dv): those of
#: every configuration the port serves (64: stablelm; 128: granite, qwen,
#: internvl2, mixtral; 256: gemma3).  Any other raises on the card.
KERNEL_HEAD_DIMS = (64, 128, 256)
#: K5's and K6's launches by head dim ("flash_attention/128", ...), counted
#: with LAUNCHES
HEAD_DIM_LAUNCHES: Dict[str, int] = {
    f"{name}/{d}": 0 for name in ("flash_attention", "flash_decode")
    for d in KERNEL_HEAD_DIMS}

#: key-tile widths of the plain versions (K6's is ``flash_decode_step``'s
#: block; any width gives the same online softmax up to f32 rounding)
PREFILL_BLOCK = 64
DECODE_BLOCK = 128
#: keys per block of K6's split-KV partial pass (``kDecodeSplit`` in
#: csrc/flash_decode.cu)
DECODE_SPLIT = 128

_c = ctypes
_PREFILL_ARGS = ([_c.c_int] + [_c.c_void_p] * 4 + [_c.c_int] * 6
                 + [_c.c_longlong] * 8 + [_c.c_float, _c.c_void_p])
_PREFILL_SM90_ARGS = ([_c.c_void_p] * 4 + [_c.c_int] * 6
                      + [_c.c_longlong] * 8 + [_c.c_float, _c.c_void_p])
_DECODE_ARGS = ([_c.c_int] + [_c.c_void_p] * 6 + [_c.c_int] * 6
                + [_c.c_longlong] * 8 + [_c.c_float, _c.c_void_p])


def reset_launches():
    for counts in (LAUNCHES, PREFILL_ROUTE_LAUNCHES, HEAD_DIM_LAUNCHES):
        for k in counts:
            counts[k] = 0


def prefill_route(dtype) -> str:
    """K5's kernel on the card for ``dtype``: ``"sm90"`` (bfloat16, tensor
    cores) or ``"scalar"`` (float32: f32 FMAs on the CUDA cores, register
    tiled; tensor cores would mean TF32, outside the fp32 tolerance).
    Raises for a dtype no kernel takes."""
    return "sm90" if dtype_code("flash_attention", dtype) == \
        DTYPE_CODE["bfloat16"] else "scalar"


def tma_aligned(data_ptr: int, strides, itemsize: int) -> bool:
    """Whether a tensor meets the 16-byte rule of TMA and of 16-byte vector
    loads: base address 16-byte aligned, last dim contiguous, every other
    stride a whole number of 16-byte words."""
    return (data_ptr % 16 == 0 and strides[-1] == 1 and
            all(s * itemsize % 16 == 0 for s in strides[:-1]))


def _check_aligned(name: str, *ts):
    for t in ts:
        if not tma_aligned(t.data_ptr(), t.stride(), t.element_size()):
            raise ValueError(
                f"{name} kernel: {tuple(t.shape)} {t.dtype} with strides "
                f"{t.stride()} at address {t.data_ptr():#x} is not 16-byte "
                f"aligned (base, and every stride but the last)")


def decode_splits(max_seq: int) -> int:
    """NSPLIT of K6's partial pass: one block per ``DECODE_SPLIT`` keys of
    the cache, from the shape alone (the host never reads ``pos``)."""
    return -(-max_seq // DECODE_SPLIT)


def decode_scratch_shape(rows: int, max_seq: int, dv: int = 64):
    """K6's f32 scratch: per (slot·head) row and split, (m, l, acc[dv])."""
    return (rows, decode_splits(max_seq), dv + 2)


def _check_head_dim(name: str, dk: int, dv: int):
    if dk != dv or dk not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name} kernel: dk == dv in {KERNEL_HEAD_DIMS} "
                         f"required, got dk={dk} dv={dv}")


def _check_cuda(name: str, *ts) -> int:
    """Validate the kernel's tensors; -> the C code of their dtype."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if t.dtype != ts[0].dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} / {ts[0].dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: last dimension must be contiguous")
    return dtype_code(name, ts[0].dtype)


# ---------------------------------------------------------------------------
# K5: prefill
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True, kv_groups: int = 1):
    """q [BH, Sq, dk]; k [BH//kv_groups, Sk, dk]; v [BH//kv_groups, Sk, dv]
    -> [BH, Sq, dv] in q's dtype.  Query head ``b`` reads kv head
    ``b // kv_groups``.  Any Sq/Sk (the kernel masks ragged tiles)."""
    bh, sq, dk = q.shape
    if kv_groups < 1 or k.shape[0] * kv_groups != bh or \
            v.shape[0] != k.shape[0] or k.shape[2] != dk or \
            v.shape[1] != k.shape[1]:
        raise ValueError(f"flash_attention: {tuple(q.shape)} q heads vs "
                         f"{tuple(k.shape)} kv heads at kv_groups={kv_groups}")
    refuse_grad("flash_attention", q, k, v)
    if _route("flash_attention", q.device) == "plain":
        return flash_attention_plain(q, k, v, causal=causal,
                                     kv_groups=kv_groups)
    code = _check_cuda("flash_attention", q, k, v)
    sk, dv = v.shape[1], v.shape[2]
    _check_head_dim("flash_attention", dk, dv)
    if bh > 65535:
        raise ValueError(f"flash_attention kernel: {bh} heads exceed the "
                         f"grid's limit of 65535")
    route = prefill_route(q.dtype)
    if route == "sm90":
        _check_aligned("flash_attention", q, k, v)
    o = torch.empty((bh, sq, dv), dtype=q.dtype, device=q.device)
    if sq == 0:
        return o
    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1),
               v.stride(0), v.stride(1), o.stride(0), o.stride(1))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "sm90":
            fn = _lib("flash_prefill_sm90", "repro_flash_prefill_sm90",
                      _PREFILL_SM90_ARGS)
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    bh, sq, sk, dk, kv_groups, int(causal), *strides,
                    dk ** -0.5, stream)
        else:
            fn = _lib("flash_prefill", "repro_flash_prefill", _PREFILL_ARGS)
            rc = fn(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    o.data_ptr(), bh, sq, sk, dk, kv_groups, int(causal),
                    *strides, dk ** -0.5, stream)
    _raise_on(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    PREFILL_ROUTE_LAUNCHES[route] += 1
    HEAD_DIM_LAUNCHES[f"flash_attention/{dk}"] += 1
    return o


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          kv_groups: int = 1):
    """Plain PyTorch version of :func:`flash_attention`: the same online
    softmax over ``PREFILL_BLOCK``-wide key tiles, f32 (m, l, acc), masked
    scores at -1e30, l clamped at 1e-30."""
    bh, sq, dk = q.shape
    sk, dv = v.shape[1], v.shape[2]
    kf, vf = k.float(), v.float()
    if kv_groups > 1:
        kf = kf.repeat_interleave(kv_groups, dim=0)
        vf = vf.repeat_interleave(kv_groups, dim=0)
    qf = q.float() * (dk ** -0.5)
    dev = q.device
    m = torch.full((bh, sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((bh, sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((bh, sq, dv), dtype=torch.float32, device=dev)
    qpos = torch.arange(sq, device=dev)[:, None]
    k_end = min(sk, sq) if causal else sk
    block = PREFILL_BLOCK
    for k0 in range(0, k_end, block):
        kj, vj = kf[:, k0:k0 + block], vf[:, k0:k0 + block]
        s = qf @ kj.transpose(1, 2)                        # [BH, Sq, bk]
        if causal:
            kpos = torch.arange(k0, k0 + kj.shape[1], device=dev)[None, :]
            valid = (qpos >= kpos)[None]
            s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        if causal:
            p = torch.where(valid, p, torch.zeros_like(p))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p @ vj
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


# ---------------------------------------------------------------------------
# K6: decode step
# ---------------------------------------------------------------------------

def flash_decode(q, k_cache, v_cache, pos, *, kv_groups: int = 1):
    """One decode step per slot against the slot-stacked cache.

    q [S·H, dk] (row ``s·H + h``); k_cache [S, max_seq, kv, dk] and v_cache
    [S, max_seq, kv, dv] in their stored layout (read by strides, never
    transposed); pos int32 [S] on the cache's device, the last valid cache
    index per slot -> [S·H, dv] in q's dtype.  ``H = kv · kv_groups``.

    On the card this is two launches (split-KV partials into an f32 scratch
    of :func:`decode_scratch_shape`, then their combine); ``LAUNCHES``
    counts the call once.  The caches must meet :func:`tma_aligned` (the
    kernel loads 16 bytes a lane); one that does not raises."""
    s_, smax, kvh, dk = k_cache.shape
    dv = v_cache.shape[-1]
    h = kvh * kv_groups
    if kv_groups < 1 or q.shape != (s_ * h, dk) or \
            v_cache.shape[:3] != (s_, smax, kvh) or tuple(pos.shape) != (s_,):
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}, pos {tuple(pos.shape)} at "
                         f"kv_groups={kv_groups}")
    if _route("flash_decode", q.device) == "plain":
        return flash_decode_plain(q, k_cache, v_cache, pos,
                                  kv_groups=kv_groups)
    refuse_grad("flash_decode", q, k_cache, v_cache)
    code = _check_cuda("flash_decode", q, k_cache, v_cache)
    if pos.device != q.device or pos.dtype != torch.int32 or \
            not pos.is_contiguous():
        raise ValueError("flash_decode: pos must be a contiguous int32 "
                         "tensor on the cache's device")
    _check_head_dim("flash_decode", dk, dv)
    _check_aligned("flash_decode", k_cache, v_cache)
    nsplit = decode_splits(smax)
    if smax < 1 or nsplit > 65535:
        raise ValueError(f"flash_decode kernel: max_seq {smax} outside "
                         f"[1, {65535 * DECODE_SPLIT}]")
    o = torch.empty((s_ * h, dv), dtype=q.dtype, device=q.device)
    if s_ == 0:
        return o
    part = torch.empty(decode_scratch_shape(s_ * h, smax, dv),
                       dtype=torch.float32, device=q.device)
    fn = _lib("flash_decode", "repro_flash_decode", _DECODE_ARGS)
    ks, vs = k_cache.stride(), v_cache.stride()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(code, q.data_ptr(), k_cache.data_ptr(),
                v_cache.data_ptr(), pos.data_ptr(), part.data_ptr(),
                o.data_ptr(), s_, h, dk, kv_groups, smax, nsplit,
                q.stride(0), ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                o.stride(0), dk ** -0.5, stream)
    _raise_on(rc, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    HEAD_DIM_LAUNCHES[f"flash_decode/{dk}"] += 1
    return o


def flash_decode_plain(q, k_cache, v_cache, pos, *, kv_groups: int = 1):
    """Plain PyTorch version of :func:`flash_decode`: the online softmax of
    ``flash_decode_step`` over ``DECODE_BLOCK``-wide KV blocks, each slot
    masked to ``[0, pos[slot]]`` (every block is visited; masking makes that
    exact)."""
    s_, smax, kvh, dk = k_cache.shape
    dv = v_cache.shape[-1]
    h = kvh * kv_groups
    dev = q.device
    qf = q.float().reshape(s_, h, 1, dk) * (dk ** -0.5)
    kf = k_cache.float().permute(0, 2, 1, 3)               # [S, kv, Smax, dk]
    vf = v_cache.float().permute(0, 2, 1, 3)
    if kv_groups > 1:
        kf = kf.repeat_interleave(kv_groups, dim=1)
        vf = vf.repeat_interleave(kv_groups, dim=1)
    p_ = pos.to(device=dev, dtype=torch.long).reshape(s_, 1, 1, 1)
    m = torch.full((s_, h, 1, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((s_, h, 1, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((s_, h, 1, dv), dtype=torch.float32, device=dev)
    block = DECODE_BLOCK
    for k0 in range(0, smax, block):
        kj, vj = kf[:, :, k0:k0 + block], vf[:, :, k0:k0 + block]
        s = qf @ kj.transpose(-1, -2)                      # [S, H, 1, bk]
        idx = torch.arange(k0, k0 + kj.shape[2], device=dev)
        valid = idx.reshape(1, 1, 1, -1) <= p_
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p @ vj
        m = m_new
    return (acc / l.clamp_min(1e-30)).reshape(s_ * h, dv).to(q.dtype)
