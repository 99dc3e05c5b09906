"""One token of Mamba-2's SSD recurrence: the port's kernel S3.

``ssd_decode_step(h, dt, A, B, C, x, D, active)`` fuses the state update
and readout of the JAX package's ``ssm_decode``
(``src/repro/models/ssm.py:181-190``)::

    h' = h * exp(dt A) + (dt B) x,   y = C . h' + D x

It is a new kernel, not a port of a TPU kernel.  A CPU tensor runs the
plain version (``ref.ssd_decode_step_plain``), a CUDA tensor runs
``csrc/ssd_decode.cu`` or raises, and a meta tensor gets empty outputs
of the kernel's shapes.  Every route books the call's ``cost.py`` count.
``LAUNCHES`` counts kernel launches only.  The kernel reads h once and writes h' once, into a fresh tensor
(the caller's cache keeps h until it rebinds its leaf), launches on the
current stream and allocates nothing itself, so a CUDA graph captures it.

B, C and x are column slices of the decode step's ``xbc`` row: any row
stride is taken, but each row's elements must be contiguous (a view with
another element stride raises; nothing is copied).  They may be bf16; the
kernel widens them.  A row's h' and y do not depend on the other rows.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import cost
from .build import dtype_code, entry, raise_on, refuse_grad, route
from .ref import ssd_decode_step_plain

__all__ = ["ssd_decode_step", "ssd_decode_step_plain", "LAUNCHES",
           "reset_launches", "THREADS"]

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"ssd_decode": 0}

#: threads of a block (``kThreads`` in csrc/ssd_decode.cu): the head dim
#: must divide it
THREADS = 256

_c = ctypes
_ARGS = ([_c.c_int] + [_c.c_void_p] * 4 + [_c.c_longlong, _c.c_void_p,
                                           _c.c_longlong, _c.c_void_p,
                                           _c.c_longlong]
         + [_c.c_void_p] * 4 + [_c.c_int] * 4 + [_c.c_void_p])


def reset_launches():
    LAUNCHES["ssd_decode"] = 0


def _check(h, dt, A, B, C, x, D, active):
    if h.dim() != 4:
        raise ValueError(f"ssd_decode_step: h [B, H, N, hd], got "
                         f"{tuple(h.shape)}")
    b, nh, n, hd = h.shape
    want = {"dt": (dt, (b, nh)), "A": (A, (nh,)), "D": (D, (nh,)),
            "B": (B, (b, n)), "C": (C, (b, n)), "x": (x, (b, nh * hd))}
    if active is not None:
        want["active"] = (active, (b,))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_decode_step: {name} {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != h.device:
            raise ValueError("ssd_decode_step: inputs on different devices")
    if any(t.dtype != torch.float32 for t in (h, dt, A, D)):
        raise TypeError("ssd_decode_step: h, dt, A and D must be float32")
    if not B.dtype == C.dtype == x.dtype:
        raise TypeError(f"ssd_decode_step: B, C and x of one dtype, got "
                        f"{B.dtype}, {C.dtype}, {x.dtype}")
    if active is not None and active.dtype != torch.bool:
        raise TypeError(f"ssd_decode_step: active must be bool, got "
                        f"{active.dtype}")


def ssd_decode_step(h: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, x: torch.Tensor,
                    D: torch.Tensor, active: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h f32 [B, H, N, hd]; dt f32 [B, H]; A, D f32 [H]; B, C [B, N] and
    x [B, H * hd] (f32 or bf16); ``active`` bool [B] or None (rows where
    it is False keep h) -> (h' f32 [B, H, N, hd], fresh; y f32 [B, H,
    hd])."""
    _check(h, dt, A, B, C, x, D, active)
    b, nh, n, hd = h.shape
    how = route("ssd_decode", h.device)
    count = cost.ssd_decode(b, nh, n, hd, B.dtype, active is not None)
    if how == "plain":
        return cost.run_plain("ssd_decode", count, ssd_decode_step_plain, h,
                              dt, A, B, C, x, D, active)
    refuse_grad("ssd_decode", h, dt, A, B, C, x, D)
    code = dtype_code("ssd_decode", B.dtype)
    if THREADS % hd:
        raise ValueError(f"ssd_decode_step: head dim {hd} must divide "
                         f"{THREADS}")
    if (2 * n + hd + THREADS) * 4 > 48 * 1024:
        raise ValueError(f"ssd_decode_step: state size {n} too large for "
                         f"the kernel's shared memory")
    if not all(t.is_contiguous() for t in (h, dt, A, D)) or \
            (active is not None and not active.is_contiguous()):
        raise ValueError("ssd_decode_step: h, dt, A, D and active must be "
                         "contiguous")
    for name, t in (("B", B), ("C", C), ("x", x)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_decode_step: {name} must have contiguous "
                             f"rows (element stride {t.stride(-1)})")
    h_out = torch.empty_like(h)
    y = torch.empty((b, nh, hd), dtype=torch.float32, device=h.device)
    cost.book("ssd_decode", count)
    if how == "meta":
        return h_out, y
    fn = entry("ssd_decode", "repro_ssd_decode", _ARGS)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = fn(code, h.data_ptr(), dt.data_ptr(), A.data_ptr(),
                B.data_ptr(), B.stride(0), C.data_ptr(), C.stride(0),
                x.data_ptr(), x.stride(0), D.data_ptr(),
                None if active is None else active.data_ptr(),
                h_out.data_ptr(), y.data_ptr(), b, nh, n, hd, stream)
    raise_on(rc, "ssd_decode")
    LAUNCHES["ssd_decode"] += 1
    return h_out, y
