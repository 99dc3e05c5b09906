"""The benchmark's frozen arithmetic: the card's peaks, the work of a model
step and of the attention kernels' calls, rooflines and percentiles.

Nothing here reads the program.  The kernel counts are copies of the rules
of ``src/repro_torch/kernels/cost.py`` as it stood when this benchmark was
written (each input read once, each output written once; FLOPs of the
visited (query, key) pairs), kept here so that a change to the program
cannot move its own yardstick.  Widths come from a configuration file
(``configs/<name>.json``, Hugging Face key names).
"""
from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence

__all__ = ["BF16_FLOPS", "F32_FLOPS", "HBM_BW", "dtype_size", "peak_flops",
           "layer_matmul_params", "prefill_flops", "decode_flops",
           "attention_count", "decode_count", "bound_s", "percentile",
           "quartile_spread"]

#: NVIDIA H100 SXM data sheet, dense, at the 700 W limit
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BW = 3.35e12


def dtype_size(dtype: str) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1,
            "int32": 4}[dtype]


def peak_flops(dtype: str) -> float:
    return BF16_FLOPS if dtype in ("bfloat16", "float16") else F32_FLOPS


# ---------------------------------------------------------------------------
# a dense decoder's model FLOPs
# ---------------------------------------------------------------------------

def _dims(cfg: dict):
    return (int(cfg["hidden_size"]), int(cfg["num_attention_heads"]),
            int(cfg["num_key_value_heads"]), int(cfg["head_dim"]),
            int(cfg["intermediate_size"]), int(cfg["vocab_size"]),
            int(cfg["num_hidden_layers"]))


def layer_matmul_params(cfg: dict) -> int:
    """Weights one token meets in one layer's projections: q, k, v, o and
    the MLP's two (three when gated) matrices."""
    d, h, kv, hd, f, _, _ = _dims(cfg)
    return d * h * hd + 2 * d * kv * hd + h * hd * d + \
        (3 if cfg["mlp_glu"] else 2) * d * f


def _pairs(sq: int, sk: int, causal: bool) -> int:
    if not causal:
        return sq * sk
    m = min(sq, sk)
    return m * (m + 1) // 2 + (sq - m) * sk


def prefill_flops(cfg: dict, length: int) -> float:
    """One prompt of ``length`` tokens: every layer's projections on every
    token, causal attention (QK^T and PV over the visited pairs), and the
    head on the last position only."""
    d, h, _, hd, _, v, n = _dims(cfg)
    per_layer = 2.0 * length * layer_matmul_params(cfg) + \
        2.0 * h * _pairs(length, length, True) * 2 * hd
    return n * per_layer + 2.0 * d * v


def decode_flops(cfg: dict, pos: int) -> float:
    """One decode step of one stream whose cache holds ``pos`` positions:
    the new token's projections, attention over ``pos + 1`` keys, the
    head."""
    d, h, _, hd, _, v, n = _dims(cfg)
    per_layer = 2.0 * layer_matmul_params(cfg) + 2.0 * h * (pos + 1) * 2 * hd
    return n * per_layer + 2.0 * d * v


# ---------------------------------------------------------------------------
# the attention kernels' calls (copies of kernels/cost.py's rules)
# ---------------------------------------------------------------------------

def attention_count(bh: int, sq: int, sk: int, dk: int, dv: int,
                    kv_groups: int, causal: bool, dtype: str):
    """K5, ``flash_attention``: q [BH, Sq, dk] and k/v [BH / kv_groups, Sk,
    dk | dv] read, o [BH, Sq, dv] written; QK^T and PV over the visited
    pairs.  -> (flops, bytes)."""
    size = dtype_size(dtype)
    nbytes = (bh * sq * (dk + dv) + (bh // kv_groups) * sk * (dk + dv)) * size
    return 2.0 * bh * _pairs(sq, sk, causal) * (dk + dv), float(nbytes)


def decode_count(slots: int, heads: int, kv: int, dk: int, dv: int,
                 rows: int, dtype: str):
    """K6, ``flash_decode``: q [S*H, dk] and int32 pos [S] read, o [S*H,
    dv] written, and ``rows`` key rows of every kv head's K and V read.
    -> (flops, bytes)."""
    size = dtype_size(dtype)
    nbytes = slots * heads * (dk + dv) * size + slots * 4 + \
        rows * kv * (dk + dv) * size
    return 2.0 * rows * heads * (dk + dv), float(nbytes)


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time (s) the card could take: the larger of the
    operations at the dtype's peak and the bytes at the HBM rate."""
    return max(flops / peak_flops(dtype), nbytes / HBM_BW)


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (0..100) of every value, by linear
    interpolation between the closest ranks; None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def quartile_spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles (Python's
    ``statistics.quantiles(values, n=4)``) as a share of the median."""
    import statistics
    q1, med, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / med
