"""The SSD inter-chunk state recurrence of Mamba-2: the port's kernel S2.

``ssd_state_scan(decay, states, h0)`` computes h_{c+1} = h_c * decay_c +
S_c over the chunks of a prompt and returns the state entering each chunk
and the final one.  It takes the place of the ``jax.lax.scan`` in the JAX
package's ``_ssd_scan`` (``src/repro/models/ssm.py:115-123``); it is a new
kernel, not a port of a TPU kernel.  A CPU tensor runs the plain version
(``ref.ssd_state_scan_plain``), a CUDA tensor runs ``csrc/ssd_scan.cu`` or
raises.  ``LAUNCHES`` counts kernel launches only.

The kernel keeps one sequential chain per state element (b, h, n, d),
four neighbouring elements a thread, and multiplies then adds (no FMA), so
it is bitwise its plain loop; ``jax.lax.scan`` takes the same steps in the
same order, and the CPU tests hold the two within f32 rounding.

``ssd_state_scan`` is differentiable: a ``torch.autograd.Function`` whose
backward is ``repro_ssd_state_scan_bwd`` in the same source (the reverse
chain gh_c = G_starts_c + decay_c gh_{c+1} from gh_nc = G_final, writing
d_states_c = gh_{c+1}, d_h0 = gh_0 and d_decay_c = sum over (N, hd) of
gh_{c+1} h_c from the saved h_starts).  d_states and d_h0 are bitwise the
plain loop ``ref.ssd_state_scan_bwd_plain``; d_decay sums in another fixed
order (per-thread, warp butterfly, then the warps' partials in index
order: no atomics, so a row's bits do not depend on B or the run).  A
gradient that autograd leaves ``None`` (h_final in training) is read as
zeros.  A CPU tensor runs the plain forward and the plain backward.
``LAUNCHES`` counts both kernels.  A meta tensor gets empty outputs of
the kernels' shapes, forward and backward, so a step traces on ``meta``;
every route books each call's ``cost.py`` count.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import cost
from .build import entry, raise_on, route
from .ref import ssd_state_scan_bwd_plain, ssd_state_scan_plain

__all__ = ["ssd_state_scan", "ssd_state_scan_plain", "ssd_state_scan_bwd",
           "ssd_state_scan_bwd_plain", "LAUNCHES", "reset_launches"]

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"ssd_state_scan": 0, "ssd_state_scan_bwd": 0}

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
#: threads a block and elements a warp-partial of the backward kernel
#: (``kThreads`` in csrc/ssd_scan.cu): the wrapper sizes the partial sums'
#: scratch for the 4-byte route, the larger
_BWD_THREADS = 256


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _forward(decay: torch.Tensor, states: torch.Tensor,
             h0: Optional[torch.Tensor]):
    if states.dim() != 5 or tuple(decay.shape) != tuple(states.shape[:3]):
        raise ValueError(f"ssd_state_scan: decay [B, nc, H] and states "
                         f"[B, nc, H, N, hd], got {tuple(decay.shape)} and "
                         f"{tuple(states.shape)}")
    b, nc, nh, n, hd = states.shape
    if h0 is not None and tuple(h0.shape) != (b, nh, n, hd):
        raise ValueError(f"ssd_state_scan: h0 {tuple(h0.shape)}, expected "
                         f"{(b, nh, n, hd)}")
    tensors = [decay, states] + ([] if h0 is None else [h0])
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("ssd_state_scan: float32 inputs required")
    if any(t.device != states.device for t in tensors):
        raise ValueError("ssd_state_scan: inputs on different devices")
    how = route("ssd_state_scan", states.device)
    count = cost.ssd_state_scan(b, nc, nh, n, hd, h0 is not None)
    if how == "plain":
        return cost.run_plain("ssd_state_scan", count, ssd_state_scan_plain,
                              decay, states, h0)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_state_scan: the kernel takes contiguous "
                         "tensors")
    h_starts = torch.empty_like(states)
    h_final = torch.empty((b, nh, n, hd), dtype=torch.float32,
                          device=states.device)
    cost.book("ssd_state_scan", count)
    if how == "meta":
        return h_starts, h_final
    fn = entry("ssd_scan", "repro_ssd_state_scan", _ARGS)
    with torch.cuda.device(states.device):
        stream = torch.cuda.current_stream(states.device).cuda_stream
        rc = fn(decay.data_ptr(), states.data_ptr(),
                None if h0 is None else h0.data_ptr(), h_starts.data_ptr(),
                h_final.data_ptr(), b, nc, nh, n * hd, stream)
    raise_on(rc, "ssd_state_scan")
    LAUNCHES["ssd_state_scan"] += 1
    return h_starts, h_final


def ssd_state_scan_bwd(decay: torch.Tensor, h_starts: torch.Tensor,
                       g_starts: Optional[torch.Tensor],
                       g_final: Optional[torch.Tensor], with_h0: bool):
    """The recurrence's backward: decay f32 [B, nc, H], the forward's
    h_starts f32 [B, nc, H, N, hd], the gradients of h_starts and h_final
    (``None`` reads as zeros) -> (d_decay, d_states, d_h0 or None)."""
    b, nc, nh, n, hd = h_starts.shape
    grads = [t for t in (g_starts, g_final) if t is not None]
    if any(t.dtype != torch.float32 or t.device != h_starts.device
           for t in grads) or \
            (g_starts is not None and g_starts.shape != h_starts.shape) or \
            (g_final is not None and tuple(g_final.shape) != (b, nh, n, hd)):
        raise ValueError("ssd_state_scan_bwd: f32 gradients of h_starts "
                         "and h_final on the states' device required")
    how = route("ssd_state_scan_bwd", h_starts.device)
    count = cost.ssd_state_scan_bwd(b, nc, nh, n, hd, g_starts is not None,
                                    g_final is not None, with_h0)
    if how == "plain":
        return cost.run_plain("ssd_state_scan_bwd", count,
                              ssd_state_scan_bwd_plain, decay, h_starts,
                              g_starts, g_final, with_h0)
    tensors = [decay, h_starts] + grads
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_state_scan_bwd: the kernel takes contiguous "
                         "tensors")
    ne = n * hd
    cap = -(-ne // _BWD_THREADS) * (_BWD_THREADS // 32)
    d_states = torch.empty_like(h_starts)
    d_decay = torch.empty_like(decay)
    d_h0 = torch.empty((b, nh, n, hd), dtype=torch.float32,
                       device=h_starts.device) if with_h0 else None
    partial = torch.empty((b * nc * nh, cap), dtype=torch.float32,
                          device=h_starts.device)
    cost.book("ssd_state_scan_bwd", count)
    if how == "meta":       # the card's outputs and scratch, nothing run
        return d_decay, d_states, d_h0
    fn = entry("ssd_scan", "repro_ssd_state_scan_bwd", _BWD_ARGS)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(h_starts.device):
        stream = torch.cuda.current_stream(h_starts.device).cuda_stream
        rc = fn(decay.data_ptr(), h_starts.data_ptr(), ptr(g_starts),
                ptr(g_final), d_states.data_ptr(), ptr(d_h0),
                partial.data_ptr(), d_decay.data_ptr(), b, nc, nh, ne, cap,
                stream)
    raise_on(rc, "ssd_state_scan_bwd")
    LAUNCHES["ssd_state_scan_bwd"] += 1
    return d_decay, d_states, d_h0


class _StateScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, decay, states, h0):
        h_starts, h_final = _forward(decay, states, h0)
        ctx.save_for_backward(decay, h_starts)
        ctx.with_h0 = h0 is not None
        ctx.set_materialize_grads(False)
        return h_starts, h_final

    @staticmethod
    def backward(ctx, g_starts, g_final):
        decay, h_starts = ctx.saved_tensors
        if g_starts is None and g_final is None:
            return None, None, None
        return ssd_state_scan_bwd(
            decay, h_starts,
            None if g_starts is None else g_starts.contiguous(),
            None if g_final is None else g_final.contiguous(), ctx.with_h0)


def ssd_state_scan(decay: torch.Tensor, states: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """decay f32 [B, nc, H], chunk states f32 [B, nc, H, N, hd], h0 f32
    [B, H, N, hd] or None (zeros) -> (h_starts f32 [B, nc, H, N, hd],
    h_final f32 [B, H, N, hd]); differentiable in decay, states and h0."""
    return _StateScan.apply(decay, states, h0)
