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

``rglru_scan`` is differentiable: a ``torch.autograd.Function`` whose
backward is a second kernel, ``repro_rglru_scan_bwd`` in the same source
(the reverse chain g_t = gh_t + a_{t+1} g_{t+1}, writing d_bx = g and
d_a_t = g_t h_{t-1} from the saved output h), bitwise its plain loop
``ref.rglru_scan_bwd_plain``.  A CPU tensor runs the plain forward and
the plain backward.  ``LAUNCHES`` counts both kernels.  A meta tensor
gets empty outputs of the kernels' shapes, forward and backward, so a
step traces on ``meta``; every route books each call's ``cost.py`` count.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import cost
from .build import entry, raise_on, route
from .ref import rglru_scan_bwd_plain, rglru_scan_plain

__all__ = ["rglru_scan", "rglru_scan_plain", "rglru_scan_bwd",
           "rglru_scan_bwd_plain", "LAUNCHES", "reset_launches", "ring",
           "STAGE_POSITIONS"]

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"rglru_scan": 0, "rglru_scan_bwd": 0}

#: positions of one ring stage, which the card tests put S around (they
#: hold it to ``ring()["positions"]``, the compiled kernel's own figure)
STAGE_POSITIONS = 64

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def ring() -> Dict[str, int]:
    """The kernels' ring as compiled: ``stages``, ``stage_bytes`` (a and bx
    of one forward stage), ``positions`` a stage, ``channels`` a block and
    ``bwd_stage_bytes`` (a, h and gh of one backward stage; the backward
    has the same stages, positions and channels).  Builds the kernel
    library on first use; launches nothing."""
    out = (ctypes.c_int * 5)()
    raise_on(entry("rglru_scan", "repro_rglru_scan_ring",
                   [ctypes.c_void_p])(ctypes.addressof(out)), "rglru_scan")
    return dict(zip(("stages", "stage_bytes", "positions", "channels",
                     "bwd_stage_bytes"), out))


def _check(name: str, *ts: torch.Tensor):
    if any(t.shape != ts[0].shape for t in ts) or ts[0].dim() != 3:
        raise ValueError(f"{name}: [B, S, w] tensors of one shape, got "
                         f"{[tuple(t.shape) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"{name}: float32 inputs required, got "
                        f"{[t.dtype for t in ts]}")
    if any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{name}: inputs on different devices")


def _launch(name: str, fn_name: str, argtypes, ins, outs):
    """Launch ``fn_name`` on contiguous f32 [B, S, w] ``ins`` -> ``outs``
    (fresh, same shape) on the current stream; counts the launch."""
    if not all(t.is_contiguous() for t in ins):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    b, s, w = ins[0].shape
    fn = entry("rglru_scan", fn_name, argtypes)
    dev = ins[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in ins + outs), b, s, w, stream)
    raise_on(rc, name)
    LAUNCHES[name] += 1


def _scan(a: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    how, count = route("rglru_scan", a.device), cost.rglru_scan(*a.shape)
    if how == "plain":
        return cost.run_plain("rglru_scan", count, rglru_scan_plain, a, bx)
    h = torch.empty_like(a)
    if how == "meta":
        if not (a.is_contiguous() and bx.is_contiguous()):
            raise ValueError("rglru_scan: the kernel takes contiguous "
                             "tensors")
    else:
        _launch("rglru_scan", "repro_rglru_scan", _ARGS, [a, bx], [h])
    cost.book("rglru_scan", count)
    return h


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, gh: torch.Tensor):
    """The scan's backward: a, its output h and gh, the gradient of h, f32
    [B, S, w] -> (d_a, d_bx) f32 [B, S, w]."""
    _check("rglru_scan_bwd", a, h, gh)
    how = route("rglru_scan_bwd", a.device)
    count = cost.rglru_scan_bwd(*a.shape)
    if how == "plain":
        return cost.run_plain("rglru_scan_bwd", count, rglru_scan_bwd_plain,
                              a, h, gh)
    d_a, d_bx = torch.empty_like(a), torch.empty_like(a)
    if how == "meta":
        if not all(t.is_contiguous() for t in (a, h, gh)):
            raise ValueError("rglru_scan_bwd: the kernel takes contiguous "
                             "tensors")
    else:
        _launch("rglru_scan_bwd", "repro_rglru_scan_bwd", _BWD_ARGS,
                [a, h, gh], [d_a, d_bx])
    cost.book("rglru_scan_bwd", count)
    return d_a, d_bx


class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, bx):
        h = _scan(a, bx)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, gh):
        a, h = ctx.saved_tensors
        return rglru_scan_bwd(a, h, gh.contiguous())


def rglru_scan(a: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """a, bx f32 [B, S, w] (same shape and device) -> h f32 [B, S, w];
    differentiable in a and bx."""
    _check("rglru_scan", a, bx)
    return _Scan.apply(a, bx)
