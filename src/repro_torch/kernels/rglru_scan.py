"""The RG-LRU linear recurrence over a sequence: the port's scan kernel.

``rglru_scan(a, bx)`` computes h_t = a_t * h_{t-1} + bx_t with h_{-1} = 0
for f32 [B, S, w] inputs.  It takes the place of the JAX package's
``jax.lax.associative_scan`` in ``rglru_train`` and the recurrent layers'
prefill; it is a new kernel, not a port of a TPU kernel.  A CPU tensor runs
the plain version (``ref.rglru_scan_plain``), a CUDA tensor runs
``csrc/rglru_scan.cu`` or raises.  ``LAUNCHES`` counts kernel launches only.

The kernel keeps one sequential chain per (row, channel) and streams a and
bx through a ring of shared-memory stages filled by ``cp.async``: a block
is one warp over 32 channels.  ``ring()`` reads the ring's geometry from
the compiled kernel.  A row's bits do not depend on B or on the grid.

The two orders of summation differ: the kernel and the plain version step
in sequence order (bitwise equal to each other), ``associative_scan``
combines in a tree, so the two agree within f32 rounding (the CPU tests
hold them to atol 1e-5).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .build import entry, raise_on, route
from .ref import rglru_scan_plain

__all__ = ["rglru_scan", "rglru_scan_plain", "LAUNCHES", "reset_launches",
           "ring", "STAGE_POSITIONS"]

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"rglru_scan": 0}

#: positions of one ring stage, which the card tests put S around (they
#: hold it to ``ring()["positions"]``, the compiled kernel's own figure)
STAGE_POSITIONS = 64

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def reset_launches():
    LAUNCHES["rglru_scan"] = 0


def ring() -> Dict[str, int]:
    """The kernel's ring as compiled: ``stages``, ``stage_bytes`` (a and bx
    of one stage), ``positions`` a stage and ``channels`` a block.  Builds
    the kernel library on first use; launches nothing."""
    out = (ctypes.c_int * 4)()
    raise_on(entry("rglru_scan", "repro_rglru_scan_ring",
                   [ctypes.c_void_p])(ctypes.addressof(out)), "rglru_scan")
    return dict(zip(("stages", "stage_bytes", "positions", "channels"), out))


def rglru_scan(a: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """a, bx f32 [B, S, w] (same shape and device) -> h f32 [B, S, w]."""
    if a.shape != bx.shape or a.dim() != 3:
        raise ValueError(f"rglru_scan: a and bx [B, S, w] of one shape, got "
                         f"{tuple(a.shape)} and {tuple(bx.shape)}")
    if a.dtype != torch.float32 or bx.dtype != torch.float32:
        raise TypeError(f"rglru_scan: float32 inputs required, got "
                        f"{a.dtype} and {bx.dtype}")
    if a.device != bx.device:
        raise ValueError("rglru_scan: a and bx on different devices")
    if route("rglru_scan", a.device) == "plain":
        return rglru_scan_plain(a, bx)
    if not (a.is_contiguous() and bx.is_contiguous()):
        raise ValueError("rglru_scan: the kernel takes contiguous tensors")
    b, s, w = a.shape
    h = torch.empty_like(a)
    fn = entry("rglru_scan", "repro_rglru_scan", _ARGS)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), bx.data_ptr(), h.data_ptr(), b, s, w, stream)
    raise_on(rc, "rglru_scan")
    LAUNCHES["rglru_scan"] += 1
    return h
