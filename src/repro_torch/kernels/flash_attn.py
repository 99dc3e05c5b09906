"""Flash attention for the serve path: prefill (K5) and the decode step (K6).

Ports of ``flash_attention`` and ``flash_decode_step`` in
``src/repro/kernels/flash_attn.py``.  Each public function is a wrapper that
dispatches on the tensors' device:

* a CPU tensor runs the function's plain PyTorch version in this module
  (the same blocked online-softmax arithmetic, in f32);
* a CUDA tensor runs the hand-written Hopper kernel in ``csrc/`` — built at
  first use, see ``build.py`` — or raises.  There is no fallback from the
  card to the plain version;
* a meta tensor passes the card route's checks and gets an empty output of
  the kernel's shape and dtype (the analysis tools' shape-only route).

Every route books the call's ``cost.py`` count (K6's at the cache's full
length: the host never reads ``pos``).

K5 has two routes on the card (:func:`prefill_route`): bfloat16 runs the
tensor-core kernels of ``flash_prefill_sm90.cu`` (wgmma + TMA: one
warpgroup a block at head dim 64, warp-specialised at 128 and 256),
float32 the register-tiled persistent SIMT kernels of ``flash_prefill.cu``
(IEEE f32 FMAs on the CUDA cores; its route keeps the name ``"scalar"``;
at 128 and 256 the kernel ``scalar_wide``, shaped by
:func:`wide_prefill_geometry`).  K6 is split-KV, a partial pass and a
combine pass: at head dims 128 and 256, bfloat16 and float32 groups of
more than two query rows run ``flash_decode_gqa.cu`` (a block reads each
K/V row once for the group's query rows; :func:`decode_geometry`), head
dim 64 and float32 groups of 1-2 ``flash_decode.cu``.  Every route takes
head dims 64, 128 and 256 (``KERNEL_HEAD_DIMS``, dk == dv) and any
``kv_groups`` that divides the heads.

``LAUNCHES`` counts kernel launches per wrapper (plain-version calls do not
count), so a run can show that its path went through the kernels;
``PREFILL_ROUTE_LAUNCHES`` splits K5's count by route and
``KERNEL_LAUNCHES`` both wrappers' by compiled kernel and head dim
(:func:`prefill_kernel`, :func:`decode_kernel`).

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
from typing import Dict, NamedTuple

import torch

from ..launch.mesh import H100_SMS
from . import cost
from .build import (DTYPE_CODE, dtype_code, entry as _lib,
                    raise_on as _raise_on, refuse_grad, route as _route)
from .ref import NEG_INF

__all__ = ["flash_attention", "flash_attention_plain", "flash_decode",
           "flash_decode_plain", "LAUNCHES", "PREFILL_ROUTE_LAUNCHES",
           "HEAD_DIM_LAUNCHES",
           "reset_launches", "KERNEL_HEAD_DIMS", "prefill_route",
           "tma_aligned", "decode_splits", "decode_scratch_shape",
           "KERNEL_LAUNCHES", "prefill_kernel", "decode_kernel",
           "decode_geometry", "DecodeGeometry", "wide_prefill_geometry",
           "WidePrefillGeometry", "gqa_f32_key_groups"]

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

#: the compiled kernels by wrapper: K5's ``sm90`` (one warpgroup, head dim
#: 64) and ``sm90_ws`` (warp-specialised, 128 and 256) in
#: flash_prefill_sm90.cu, ``scalar`` (fp32, head dim 64) and
#: ``scalar_wide`` (fp32, 128 and 256) in flash_prefill.cu; K6's ``split``
#: (flash_decode.cu) and ``gqa_mma`` / ``gqa_simt`` (bf16) and ``gqa_f32``
#: (fp32) in flash_decode_gqa.cu
KERNELS = {"flash_attention": ("sm90", "sm90_ws", "scalar", "scalar_wide"),
           "flash_decode": ("split", "gqa_mma", "gqa_simt", "gqa_f32")}
#: launches by "<wrapper>/<kernel>/<head dim>", counted with LAUNCHES
KERNEL_LAUNCHES: Dict[str, int] = {
    f"{name}/{kern}/{d}": 0 for name, kerns in KERNELS.items()
    for kern in kerns for d in KERNEL_HEAD_DIMS}

#: key-tile widths of the plain versions (K6's is ``flash_decode_step``'s
#: block; any width gives the same online softmax up to f32 rounding)
PREFILL_BLOCK = 64
DECODE_BLOCK = 128
#: keys per block of K6's split-KV partial pass (``kDecodeSplit`` in
#: csrc/flash_decode.cu)
DECODE_SPLIT = 128
#: flash_decode_gqa.cu: keys a ring stage by kernel (``Geo::TK``; for
#: ``gqa_f32`` by head dim, ``F32_TK``: two warps' keys), the keys a split
#: is a multiple of, query rows of an m16 tile, the m16 tiles a block holds
#: at most by head dim (``kMmaTiles``; ``F32_TILES`` for ``gqa_f32``), and
#: the pass-1 blocks a slot aims at (so that a few slots fill 132 SMs)
GQA_TILE = {"gqa_mma": 64, "gqa_simt": 32}
GQA_F32_STAGE = {128: 64, 256: 32}
GQA_SPLIT_UNIT = {"gqa_mma": 64, "gqa_simt": 32, "gqa_f32": 64}
GQA_MMA_ROWS = 16
GQA_MMA_TILES = {128: 3, 256: 2}
GQA_F32_TILES = 4
GQA_BLOCKS_PER_SLOT = 64
#: flash_prefill.cu's kernel at head dims 128 and 256: query rows of a work
#: item by head dim (``XGeo::ROWS``: 8 warps of 16 or 8) and keys of a K/V
#: tile (``kXKeys``)
WIDE_ROWS = {128: 128, 256: 64}
WIDE_KEYS = 64

_c = ctypes
_PREFILL_ARGS = ([_c.c_int] + [_c.c_void_p] * 4 + [_c.c_int] * 6
                 + [_c.c_longlong] * 8 + [_c.c_float, _c.c_void_p])
_PREFILL_SM90_ARGS = ([_c.c_void_p] * 4 + [_c.c_int] * 6
                      + [_c.c_longlong] * 8 + [_c.c_float, _c.c_void_p])
_PREFILL_WIDE_ARGS = ([_c.c_void_p] * 5 + [_c.c_int] * 9
                      + [_c.c_longlong] * 8 + [_c.c_float, _c.c_void_p])
_DECODE_ARGS = ([_c.c_int] + [_c.c_void_p] * 6 + [_c.c_int] * 6
                + [_c.c_longlong] * 8 + [_c.c_float, _c.c_void_p])
_DECODE_GQA_ARGS = ([_c.c_void_p] * 6 + [_c.c_int] * 7
                    + [_c.c_longlong] * 8 + [_c.c_float, _c.c_void_p])


def reset_launches():
    for counts in (LAUNCHES, PREFILL_ROUTE_LAUNCHES, HEAD_DIM_LAUNCHES,
                   KERNEL_LAUNCHES):
        for k in counts:
            counts[k] = 0


def prefill_route(dtype) -> str:
    """K5's kernel on the card for ``dtype``: ``"sm90"`` (bfloat16, tensor
    cores) or ``"scalar"`` (float32: f32 FMAs on the CUDA cores, register
    tiled; tensor cores would mean TF32, outside the fp32 tolerance).
    Raises for a dtype no kernel takes."""
    return "sm90" if dtype_code("flash_attention", dtype) == \
        DTYPE_CODE["bfloat16"] else "scalar"


def prefill_kernel(dtype, d: int) -> str:
    """K5's compiled kernel on the card (a ``KERNELS`` name) for ``dtype``
    at head dim ``d``."""
    if prefill_route(dtype) == "scalar":
        return "scalar" if d == 64 else "scalar_wide"
    return "sm90" if d == 64 else "sm90_ws"


class WidePrefillGeometry(NamedTuple):
    """``scalar_wide``'s launch: heads an item packs (``hs``), chunks each
    item's key tiles are cut into (``nc``; over 1, a merge launch
    follows), work units (items x nc) and persistent blocks."""
    hs: int
    nc: int
    units: int
    grid: int


def wide_prefill_geometry(bh: int, sq: int, sk: int, d: int, groups: int,
                          causal: bool, sms: int) -> WidePrefillGeometry:
    """K5 fp32 at head dims 128 and 256 (flash_prefill.cu's tiled kernel):
    an item is ``WIDE_ROWS[d]`` query rows, ``hs`` heads of one kv group
    (the largest of 8, 4, 2, 1 that divides ``groups``) at ``WIDE_ROWS[d] /
    hs`` positions; with fewer items than ``sms`` each item's key tiles are
    cut into ``nc`` chunks (at most one a tile) so that the units fill the
    card.  Granite [48, 1024, 128] (groups 48): hs 8, 384 items, nc 1;
    gemma3 [8, 512, 256] (groups 2): hs 2, 64 items, nc 3."""
    hs = next(h for h in (8, 4, 2, 1) if groups % h == 0)
    items = (bh // groups) * (groups // hs) * -(-sq // (WIDE_ROWS[d] // hs))
    k_end = min(sk, sq) if causal else sk
    tiles = -(-k_end // WIDE_KEYS)
    nc = 1 if items >= sms else max(1, min(-(-sms // items), tiles))
    units = items * nc
    return WidePrefillGeometry(hs, nc, units, min(units, sms))


def decode_kernel(dtype, d: int, groups: int) -> str:
    """K6's compiled kernel on the card for ``dtype``, head dim ``d`` and
    ``groups`` query heads a kv head: at 128 and 256, bfloat16 runs
    flash_decode_gqa.cu, on tensor cores when the group has more than two
    rows (``gqa_mma``), in f32 SIMT otherwise (``gqa_simt``), and float32
    groups of more than two rows its f32 register tiles (``gqa_f32``);
    head dim 64 and float32 groups of 1-2 run flash_decode.cu
    (``split``)."""
    bf16 = dtype_code("flash_decode", dtype) == DTYPE_CODE["bfloat16"]
    if d == 64 or (not bf16 and groups <= 2):
        return "split"
    if not bf16:
        return "gqa_f32"
    return "gqa_mma" if groups > 2 else "gqa_simt"


class DecodeGeometry(NamedTuple):
    """K6's launch geometry: the kernel, keys a pass-1 block (``split``),
    NSPLIT, and pass-1 blocks a (slot, kv head, split) that share the
    group's query rows (``head_tiles``)."""
    kernel: str
    split: int
    nsplit: int
    head_tiles: int


def decode_geometry(max_seq: int, kv: int, groups: int, d: int,
                    dtype=torch.bfloat16) -> DecodeGeometry:
    """K6's geometry from the cache's shape alone (never the slot count or
    ``pos``, so a slot decodes bitwise alike in any batch).  flash_decode.cu
    takes ``DECODE_SPLIT`` keys a block.  flash_decode_gqa.cu splits a
    group's heads into m16 tiles (``gqa_mma``, ``gqa_f32``) and takes the
    smallest multiple of its split unit ``GQA_SPLIT_UNIT`` that still gives
    each slot about ``GQA_BLOCKS_PER_SLOT`` blocks: granite (kv 1, G 48,
    max_seq 1024) 64 keys, 16 splits, its 3 m16 tiles in one block (bf16
    and fp32); gemma3 (kv 4, G 2, 4096) 256 keys, 16 splits (bf16)."""
    kernel = decode_kernel(dtype, d, groups)
    if kernel == "split":
        return DecodeGeometry(kernel, DECODE_SPLIT, decode_splits(max_seq), 1)
    tiles = 1
    if kernel != "gqa_simt":     # m16 tiles, up to a block's share
        m16 = -(-groups // GQA_MMA_ROWS)
        cap = GQA_F32_TILES if kernel == "gqa_f32" else GQA_MMA_TILES[d]
        tiles = -(-m16 // min(m16, cap))
    tk = GQA_SPLIT_UNIT[kernel]
    want = -(-GQA_BLOCKS_PER_SLOT // (kv * tiles))  # splits a slot's pair
    split = tk * max(1, -(-max_seq // (tk * want)))
    return DecodeGeometry(kernel, split, -(-max_seq // split), tiles)


def gqa_f32_key_groups(d: int, groups: int) -> int:
    """``gqa_f32``'s warps a stage's keys are split between (``F32_KQ``):
    4 at head dim 128 while a block holds up to 3 m16 tiles of the group
    (granite's 48 rows: 12 warps), else 2."""
    tiles = min(-(-groups // GQA_MMA_ROWS), GQA_F32_TILES)
    return 4 if d == 128 and tiles <= 3 else 2


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


def decode_scratch_shape(rows: int, max_seq: int, dv: int = 64, *,
                         kv: int = 1, groups: int = 1,
                         dtype=torch.bfloat16):
    """K6's f32 scratch: per (slot·head) row and split, (m, l, acc[dv]),
    NSPLIT from :func:`decode_geometry`."""
    return (rows, decode_geometry(max_seq, kv, groups, dv, dtype).nsplit,
            dv + 2)


_SMS: Dict[int, int] = {}


def _sm_count(device) -> int:
    """The card's streaming multiprocessors (read once per device); the
    H100's 132 for a meta tensor, which stands for one."""
    if device.type == "meta":
        return H100_SMS
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    return _SMS[idx]


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
    sk, dv = v.shape[1], v.shape[2]
    how = _route("flash_attention", q.device)
    count = cost.flash_attention(bh, sq, sk, dk, dv, kv_groups, causal,
                                 q.dtype)
    if how == "plain":
        return cost.run_plain("flash_attention", count,
                              flash_attention_plain, q, k, v, causal=causal,
                              kv_groups=kv_groups)
    code = _check_cuda("flash_attention", q, k, v)
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
    geo = part = None
    if route == "scalar" and dk != 64:
        geo = wide_prefill_geometry(bh, sq, sk, dk, kv_groups, causal,
                                    _sm_count(q.device))
        part = torch.empty((bh * sq, geo.nc, dv + 4), dtype=torch.float32,
                           device=q.device) if geo.nc > 1 else None
    cost.book("flash_attention", count)
    if how == "meta":       # the card's output and scratch, nothing run
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
        elif dk == 64:
            fn = _lib("flash_prefill", "repro_flash_prefill", _PREFILL_ARGS)
            rc = fn(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    o.data_ptr(), bh, sq, sk, dk, kv_groups, int(causal),
                    *strides, dk ** -0.5, stream)
        else:
            fn = _lib("flash_prefill", "repro_flash_prefill_wide",
                      _PREFILL_WIDE_ARGS)
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    part.data_ptr() if part is not None else None, bh, sq,
                    sk, dk, kv_groups, int(causal), geo.hs, geo.nc, geo.grid,
                    *strides, dk ** -0.5, stream)
    _raise_on(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    PREFILL_ROUTE_LAUNCHES[route] += 1
    HEAD_DIM_LAUNCHES[f"flash_attention/{dk}"] += 1
    KERNEL_LAUNCHES[f"flash_attention/{prefill_kernel(q.dtype, dk)}/{dk}"] \
        += 1
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
    how = _route("flash_decode", q.device)
    count = cost.flash_decode(s_, h, kvh, dk, dv, smax, q.dtype)
    if how == "plain":
        return cost.run_plain("flash_decode", count, flash_decode_plain, q,
                              k_cache, v_cache, pos, kv_groups=kv_groups)
    refuse_grad("flash_decode", q, k_cache, v_cache)
    code = _check_cuda("flash_decode", q, k_cache, v_cache)
    if pos.device != q.device or pos.dtype != torch.int32 or \
            not pos.is_contiguous():
        raise ValueError("flash_decode: pos must be a contiguous int32 "
                         "tensor on the cache's device")
    _check_head_dim("flash_decode", dk, dv)
    _check_aligned("flash_decode", k_cache, v_cache)
    geo = decode_geometry(max(smax, 1), kvh, kv_groups, dk, q.dtype)
    if smax < 1 or geo.nsplit > 65535:
        raise ValueError(f"flash_decode kernel: max_seq {smax} outside "
                         f"[1, {65535 * geo.split}]")
    if geo.kernel != "split" and s_ * kvh > 65535:
        raise ValueError(f"flash_decode kernel: {s_} x {kvh} (slot, kv "
                         f"head) pairs exceed the grid's limit of 65535")
    o = torch.empty((s_ * h, dv), dtype=q.dtype, device=q.device)
    if s_ == 0:
        return o
    part = torch.empty(decode_scratch_shape(s_ * h, smax, dv, kv=kvh,
                                            groups=kv_groups,
                                            dtype=q.dtype),
                       dtype=torch.float32, device=q.device)
    cost.book("flash_decode", count)
    if how == "meta":       # the card's output and scratch, nothing run
        return o
    ks, vs = k_cache.stride(), v_cache.stride()
    strides = (q.stride(0), ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
               o.stride(0))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if geo.kernel == "split":
            fn = _lib("flash_decode", "repro_flash_decode", _DECODE_ARGS)
            rc = fn(code, q.data_ptr(), k_cache.data_ptr(),
                    v_cache.data_ptr(), pos.data_ptr(), part.data_ptr(),
                    o.data_ptr(), s_, h, dk, kv_groups, smax, geo.nsplit,
                    *strides, dk ** -0.5, stream)
        else:
            fn = _lib("flash_decode_gqa", "repro_flash_decode_gqa_f32"
                      if geo.kernel == "gqa_f32" else
                      "repro_flash_decode_gqa", _DECODE_GQA_ARGS)
            rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    pos.data_ptr(), part.data_ptr(), o.data_ptr(), s_, h,
                    dk, kv_groups, smax, geo.split, geo.nsplit, *strides,
                    dk ** -0.5, stream)
    _raise_on(rc, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    HEAD_DIM_LAUNCHES[f"flash_decode/{dk}"] += 1
    KERNEL_LAUNCHES[f"flash_decode/{geo.kernel}/{dk}"] += 1
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
