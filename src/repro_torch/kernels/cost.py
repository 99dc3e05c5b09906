"""One count per kernel: the FLOPs and HBM bytes of a call, from shapes,
dtypes and flags alone.

Each function below reads the same work whatever implements it: the CUDA
kernel on the card, its plain version on the CPU, or the meta route of the
analysis tools.  Bytes are what the call must move, each input read once
and each output written once (a kernel's scratch is not counted); FLOPs
are the arithmetic the call does on them.  Both are the numbers that
``chip_smoke.py`` divides by the card's rates for each kernel's bound
(:func:`bound`), and that the dry run's counter
(``launch/hlo_analysis.py``) adds for each kernel call, since a ctypes
launch is invisible to a ``TorchDispatchMode``.

K6 (``flash_decode``) reads each slot's keys up to its position, which
only the data knows.  Its count takes ``rows``, the key rows read over all
slots; the wrappers book the shape's most, ``slots * max_seq`` (the host
never reads ``pos``), and chip_smoke's bound counts the rows its draw of
positions needs.

:func:`book` adds a kernel call to the active counter, and does nothing
when none is active.  The counters form one process-wide stack (autograd
runs a CUDA backward on a thread of its own, whose kernels must be booked
too).
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional

from ..launch.mesh import H100_BF16_FLOPS, H100_F32_FLOPS, H100_HBM_BW

__all__ = ["Count", "quantize8", "dequantize8", "sparse_enc", "sparse_dec",
           "flash_attention", "flash_decode", "rglru_scan", "rglru_scan_bwd",
           "ssd_state_scan", "ssd_state_scan_bwd", "ssd_decode", "norm",
           "rotary", "peak_flops",
           "bound", "bound_ms", "book", "run_plain", "active", "COUNTERS"]


class Count(NamedTuple):
    """A kernel call's work: ``flops``, HBM ``bytes``, and the ``dtype``
    whose peak its operations run at (``"bfloat16"``: the tensor cores;
    ``"float32"``: the CUDA cores)."""
    flops: float
    bytes: float
    dtype: str = "float32"


def _tag(dtype) -> str:
    return str(dtype).rpartition(".")[2]


def _size(dtype) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1,
            "int32": 4}[_tag(dtype)]


# ---------------------------------------------------------------------------
# the counts
# ---------------------------------------------------------------------------

def quantize8(m: int, n: int) -> Count:
    """K1: f32 [M, N] read; int8 [M, N] and f32 scales [M/32, N/128]
    written; |x|, the tile's max and x / scale an element."""
    return Count(3.0 * m * n, m * n * 4 + m * n + (m // 32) * (n // 128) * 4)


def dequantize8(m: int, n: int) -> Count:
    """K2: int8 [M, N] and its scales read, f32 [M, N] written; one
    product an element."""
    return Count(1.0 * m * n, m * n + (m // 32) * (n // 128) * 4 + m * n * 4)


def sparse_enc(n: int, kb: int, dtype, totals: bool = False) -> Count:
    """K3: flat [n] read; values [nb*kb] (flat's dtype), int32 indices
    [nb*kb], int32 counts [nb] (and totals [nb]) written; one compare an
    element."""
    nb = n // 512
    size = _size(dtype)
    return Count(1.0 * n, n * size + nb * kb * (size + 4)
                 + nb * 4 * (2 if totals else 1))


def sparse_dec(nb: int, kb: int, dtype) -> Count:
    """K4: values and int32 indices [nb, kb] read, dense [nb*512] written;
    a scatter, no arithmetic."""
    size = _size(dtype)
    return Count(0.0, nb * kb * (size + 4) + nb * 512 * size)


def _pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs a head visits: query i reads keys 0..i when
    causal (the kernel's mask, no offset), all ``sk`` otherwise."""
    if not causal:
        return sq * sk
    m = min(sq, sk)
    return m * (m + 1) // 2 + (sq - m) * sk


def flash_attention(bh: int, sq: int, sk: int, dk: int, dv: int,
                    kv_groups: int, causal: bool, dtype) -> Count:
    """K5: q [BH, Sq, dk] and k/v [BH / kv_groups, Sk, dk | dv] read, o
    [BH, Sq, dv] written; QK^T and PV over the visited pairs, at the
    dtype's peak."""
    size = _size(dtype)
    nbytes = (bh * sq * (dk + dv) + (bh // kv_groups) * sk * (dk + dv)) * size
    return Count(2.0 * bh * _pairs(sq, sk, causal) * (dk + dv), nbytes,
                 _tag(dtype))


def flash_decode(slots: int, heads: int, kv: int, dk: int, dv: int,
                 max_seq: int, dtype, rows: Optional[int] = None) -> Count:
    """K6: q [S*H, dk] and int32 pos [S] read, o [S*H, dv] written, and
    ``rows`` key rows of every kv head's K and V read (default: the
    shape's most, ``slots * max_seq``; the data's own is the sum over slots
    of pos + 1)."""
    rows = slots * max_seq if rows is None else rows
    size = _size(dtype)
    nbytes = slots * heads * (dk + dv) * size + slots * 4 + \
        rows * kv * (dk + dv) * size
    return Count(2.0 * rows * heads * (dk + dv), nbytes, _tag(dtype))


def rglru_scan(b: int, s: int, w: int) -> Count:
    """S1: a, bx f32 [B, S, w] read, h written; a product and a sum an
    element."""
    return Count(2.0 * b * s * w, 3 * b * s * w * 4)


def rglru_scan_bwd(b: int, s: int, w: int) -> Count:
    """S1's backward: a, h, gh read; d_a, d_bx written."""
    return Count(3.0 * b * s * w, 5 * b * s * w * 4)


def ssd_state_scan(b: int, nc: int, h: int, n: int, hd: int,
                   h0: bool = False) -> Count:
    """S2: decay f32 [B, nc, H] and states f32 [B, nc, H, N, hd] (and h0)
    read; h_starts [B, nc, H, N, hd] and h_final [B, H, N, hd] written."""
    states, state = b * nc * h * n * hd, b * h * n * hd
    return Count(2.0 * states, (2 * states + b * nc * h + state
                                + (state if h0 else 0)) * 4)


def ssd_state_scan_bwd(b: int, nc: int, h: int, n: int, hd: int,
                       g_starts: bool = True, g_final: bool = True,
                       with_h0: bool = False) -> Count:
    """S2's backward: decay and h_starts (and the gradients of h_starts
    and h_final that autograd gives) read; d_states, d_decay (and d_h0)
    written."""
    states, state = b * nc * h * n * hd, b * h * n * hd
    nbytes = 2 * states + (states if g_starts else 0) \
        + (state if g_final else 0) + (state if with_h0 else 0) \
        + 2 * b * nc * h
    return Count(4.0 * states, nbytes * 4)


def ssd_decode(b: int, h: int, n: int, hd: int, dtype,
               active: bool = False) -> Count:
    """S3: h f32 [B, H, N, hd], dt f32 [B, H], A and D f32 [H], B and C
    [B, N] and x [B, H*hd] in ``dtype`` (and the active mask) read; h' and
    y f32 [B, H, hd] written; h * decay, (dt B) x, their sum and C . h' (a
    product and a sum) a state element."""
    state = b * h * n * hd
    nbytes = 2 * state * 4 + b * h * hd * 4 + b * h * 4 \
        + b * (2 * n + h * hd) * _size(dtype) + 2 * h * 4 \
        + (b if active else 0)
    return Count(5.0 * state, nbytes)


def norm(rows: int, d: int, dtype, layernorm: bool = False) -> Count:
    """S4: x [rows, d] in ``dtype`` and f32 scale (and bias) [d] read, y
    [rows, d] written.  FLOPs by XLA's rules (one an element of each
    elementwise op, a dtype conversion included; ``in - out`` a reduction;
    the rsqrt a transcendental, not counted) over the expression it
    replaces, ``ref.norm_plain``: the dry run's totals stay those of the
    JAX package's program."""
    size, n = _size(dtype), rows * d
    per = (8 if layernorm else 4) + (2 if size == 2 else 0)
    return Count(float(per * n + rows),
                 2 * n * size + d * 4 * (2 if layernorm else 1))


def rotary(b: int, s: int, heads: int, hd: int, rot: int, dtype,
           tensors: int = 1, pos_size: int = 4) -> Count:
    """S5: ``tensors`` tensors of ``heads`` heads in all, [B, S, heads, hd]
    in ``dtype``, read and written whole, and the positions [B, S] read
    once.  FLOPs by XLA's rules over ``ref.rotary_plain`` run once a tensor
    (as :func:`norm`): four products, a difference and a sum a pair, the
    rounding to bf16, and each call's angle table."""
    size = _size(dtype)
    per = 3 + (1 if size == 2 else 0)
    table = b * s + b * s * (rot // 2) + 3 * (rot // 2)
    return Count(float(b * s * heads * rot * per + tensors * table),
                 2 * b * s * heads * hd * size + b * s * pos_size)


# ---------------------------------------------------------------------------
# bounds on the H100
# ---------------------------------------------------------------------------

def peak_flops(dtype) -> float:
    """The card's peak FLOP/s for work in ``dtype``: the dense bf16 tensor
    cores, or float32 outside them."""
    return H100_BF16_FLOPS if _tag(dtype) in ("bfloat16", "float16") \
        else H100_F32_FLOPS


def bound(count: Count, dtype=None) -> dict:
    """The byte bound (the bytes at the HBM rate) and the operation bound
    (the FLOPs at the peak of ``dtype``, default the count's own), in ms,
    the larger as ``bound_ms`` and which one it is as ``bound_by``."""
    t_b = count.bytes / H100_HBM_BW * 1e3
    t_f = count.flops / peak_flops(dtype or count.dtype) * 1e3
    return dict(bytes_bound_ms=t_b, ops_bound_ms=t_f, bound_ms=max(t_b, t_f),
                bound_by="bytes" if t_b >= t_f else "operations")


def bound_ms(count: Count, dtype=None) -> float:
    """The least time (ms) the card could take for ``count``."""
    return bound(count, dtype)["bound_ms"]


# ---------------------------------------------------------------------------
# the active counter
# ---------------------------------------------------------------------------

#: the active counters, innermost last (``hlo_analysis.CostCounter``
#: enters itself): objects with ``kernel(name, count, outputs)``,
#: ``collective(kind, nbytes)`` and a ``paused()`` context
COUNTERS: List[Any] = []


def active():
    """The innermost active counter, or None."""
    return COUNTERS[-1] if COUNTERS else None


def book(name: str, count: Count, outputs=None):
    """Add one call of kernel ``name`` with ``count`` (and its output
    tensors, for the counter's live bytes) to the active counter."""
    c = active()
    if c is not None:
        c.kernel(name, count, outputs)


def run_plain(name: str, count: Count, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` (a kernel's plain version) booked as one
    call of kernel ``name``: the active counter sees the kernel's count,
    not the plain version's operations."""
    c = active()
    if c is None:
        return fn(*args, **kwargs)
    with c.paused():
        out = fn(*args, **kwargs)
    c.kernel(name, count, out)
    return out
