"""Row normalisation over the last dim, RMSNorm or LayerNorm: the port's
kernel S4.

``norm(x, scale, bias=None)`` is ``models/layers.py``'s ``apply_norm``:
f32 statistics, f32 ``scale`` (and ``bias``) [d], the output in x's dtype
(bf16 or f32); RMSNorm (eps 1e-6) without ``bias``, LayerNorm (eps 1e-5)
with it.  It is a new kernel, not a port of a TPU kernel (the JAX package
leaves the expression to XLA, which fuses it).

A CPU tensor runs the plain version (``ref.norm_plain``, the expression as
it was), a CUDA tensor runs ``csrc/norm.cu`` or raises, and a meta tensor
gets an empty output of the kernel's shape.  Every route books the call's
``cost.py`` count; ``LAUNCHES`` counts kernel launches only.  The kernel
reads x once and writes a fresh contiguous y once, launches on the current
stream and allocates nothing itself, so a CUDA graph captures it.

x may be a view: its rows may have any strides as long as each row's
elements are contiguous and the leading dims fold into at most two
(``dkv[..., :r_kv]`` of MLA, ``x[:, -1:]`` before the head).  A row's
output does not depend on the other rows.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import cost
from .build import dtype_code, entry, raise_on, refuse_grad, route
from .ref import norm_plain

__all__ = ["norm", "norm_plain", "LAUNCHES", "reset_launches", "row_levels"]

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"norm": 0}

_c = ctypes
_ARGS = ([_c.c_int, _c.c_int, _c.c_void_p, _c.c_longlong, _c.c_longlong,
          _c.c_longlong, _c.c_int, _c.c_void_p, _c.c_void_p, _c.c_void_p,
          _c.c_int, _c.c_float, _c.c_void_p])


def reset_launches():
    LAUNCHES["norm"] = 0


def row_levels(x: torch.Tensor) -> Optional[Tuple[int, int, int, int]]:
    """The rows of x [..., d] as (outer, inner, outer_stride, inner_stride):
    row r at ``(r // inner) * outer_stride + (r % inner) * inner_stride``
    elements; None where the leading dims do not fold into two levels."""
    dims = [(n, st) for n, st in zip(x.shape[:-1], x.stride()[:-1]) if n != 1]
    folded = []
    for n, st in reversed(dims):            # innermost first
        if folded and folded[-1][1] * folded[-1][0] == st:
            folded[-1] = (folded[-1][0] * n, folded[-1][1])
        else:
            folded.append((n, st))
    if len(folded) > 2:
        return None
    folded += [(1, 0)] * (2 - len(folded))
    (inner, s_in), (outer, s_out) = folded
    return outer, inner, s_out, s_in


def _check(x, scale, bias):
    d = x.shape[-1] if x.dim() else 0
    if x.dim() < 1 or d == 0:
        raise ValueError(f"norm: x [..., d] with d > 0, got {tuple(x.shape)}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is None:
            continue
        if tuple(t.shape) != (d,):
            raise ValueError(f"norm: {name} {tuple(t.shape)}, expected ({d},)")
        if t.dtype != torch.float32:
            raise TypeError(f"norm: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError("norm: inputs on different devices")


def norm(x: torch.Tensor, scale: torch.Tensor,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., d] (f32 or bf16); scale (and bias) f32 [d] -> y [..., d] in
    x's dtype, contiguous: RMSNorm without ``bias``, LayerNorm with it."""
    _check(x, scale, bias)
    d = x.shape[-1]
    rows = x.numel() // d
    how = route("norm", x.device)
    count = cost.norm(rows, d, x.dtype, bias is not None)
    if how == "plain":
        return cost.run_plain("norm", count, norm_plain, x, scale, bias)
    refuse_grad("norm", x, scale, bias)
    code = dtype_code("norm", x.dtype)
    levels = row_levels(x)
    if (x.stride(-1) != 1 and d > 1) or levels is None:
        raise ValueError(f"norm: each row's elements must be contiguous and "
                         f"the rows two levels of strides, got strides "
                         f"{x.stride()} for {tuple(x.shape)}")
    if not scale.is_contiguous() or (bias is not None and
                                     not bias.is_contiguous()):
        raise ValueError("norm: scale and bias must be contiguous")
    outer, inner, s_out, s_in = levels
    size = x.element_size()
    vec = d % (16 // size) == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, scale, bias) if t is not None) \
        and (s_out * size) % 16 == 0 and (s_in * size) % 16 == 0
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    cost.book("norm", count)
    if how == "meta":
        return y
    fn = entry("norm", "repro_norm", _ARGS)
    eps = 1e-5 if bias is not None else 1e-6
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(code, int(vec), x.data_ptr(), s_out, s_in, rows, inner,
                scale.data_ptr(), None if bias is None else bias.data_ptr(),
                y.data_ptr(), d, eps, stream)
    raise_on(rc, "norm")
    LAUNCHES["norm"] += 1
    return y
