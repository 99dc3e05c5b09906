"""Per-tile symmetric int8 quantization (the quant8 wire codec): K1 and K2.

Ports of ``quantize8_pallas`` and ``dequantize8_pallas`` in
``src/repro/kernels/quant8.py``.  Each wrapper dispatches on the tensors'
device: a CPU tensor runs the plain version (``ref.quantize8_plain`` /
``ref.dequantize8_plain``), a CUDA tensor runs the hand-written kernel in
``csrc/quant8.cu`` or raises, and a meta tensor gets empty outputs of the
kernel's shapes (``build.route``).  ``LAUNCHES`` counts kernel launches
only; every route books the call's ``cost.py`` count.
Shapes, padding and the stacked framing live in ``ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import cost
from .build import entry, raise_on, refuse_grad, route
from .ref import (QUANT_BM, QUANT_BN, dequantize8_plain, quantize8_plain)

__all__ = ["quantize8", "dequantize8", "LAUNCHES", "reset_launches"]

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"quantize8": 0, "dequantize8": 0}

_c = ctypes
_QUANT_ARGS = [_c.c_void_p] * 3 + [_c.c_int] * 2 + [_c.c_void_p]


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_tiles(name: str, t: torch.Tensor):
    if t.dim() != 2 or t.shape[0] % QUANT_BM or t.shape[1] % QUANT_BN:
        raise ValueError(f"{name}: [M, N] with M % {QUANT_BM} == 0 and "
                         f"N % {QUANT_BN} == 0 required, got "
                         f"{tuple(t.shape)}")


def _check_cuda(name: str, f32: torch.Tensor, *rest: torch.Tensor):
    """The kernels move the f32 frame as float4 (16-byte aligned) and the
    int8 tiles as char4 (4-byte aligned); scales are read one by one."""
    for t, align in ((f32, 16),) + tuple((t, 4) for t in rest):
        if t.device != f32.device:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{name}: the kernel takes contiguous tensors, "
                             f"{align}-byte aligned")


def quantize8(x: torch.Tensor):
    """x f32 [M, N] (M % 32 == N % 128 == 0) -> (q int8 [M, N], scales f32
    [M/32, N/128])."""
    _check_tiles("quantize8", x)
    if x.dtype != torch.float32:
        raise TypeError(f"quantize8: float32 input required, got {x.dtype}")
    m, n = x.shape
    how, count = route("quantize8", x.device), cost.quantize8(m, n)
    if how == "plain":
        return cost.run_plain("quantize8", count, quantize8_plain, x)
    refuse_grad("quantize8", x)
    _check_cuda("quantize8", x)
    q = torch.empty((m, n), dtype=torch.int8, device=x.device)
    s = torch.empty((m // QUANT_BM, n // QUANT_BN), dtype=torch.float32,
                    device=x.device)
    cost.book("quantize8", count)
    if how == "meta":
        return q, s
    fn = entry("quant8", "repro_quantize8", _QUANT_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), m, n, stream)
    raise_on(rc, "quantize8")
    LAUNCHES["quantize8"] += 1
    return q, s


def dequantize8(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 [M, N] + f32 [M/32, N/128] -> f32 [M, N]."""
    _check_tiles("dequantize8", q)
    m, n = q.shape
    if q.dtype != torch.int8 or scales.dtype != torch.float32 or \
            tuple(scales.shape) != (m // QUANT_BM, n // QUANT_BN):
        raise ValueError(f"dequantize8: int8 {tuple(q.shape)} with f32 "
                         f"scales {tuple(scales.shape)}")
    how, count = route("dequantize8", q.device), cost.dequantize8(m, n)
    if how == "plain":
        return cost.run_plain("dequantize8", count, dequantize8_plain, q,
                              scales)
    refuse_grad("dequantize8", q, scales)
    x = torch.empty((m, n), dtype=torch.float32, device=q.device)
    _check_cuda("dequantize8", x, q, scales)
    cost.book("dequantize8", count)
    if how == "meta":
        return x
    fn = entry("quant8", "repro_dequantize8", _QUANT_ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), scales.data_ptr(), x.data_ptr(), m, n, stream)
    raise_on(rc, "dequantize8")
    LAUNCHES["dequantize8"] += 1
    return x
