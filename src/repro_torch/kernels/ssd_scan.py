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
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .build import entry, raise_on, route
from .ref import ssd_state_scan_plain

__all__ = ["ssd_state_scan", "ssd_state_scan_plain", "LAUNCHES",
           "reset_launches"]

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"ssd_state_scan": 0}

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def reset_launches():
    LAUNCHES["ssd_state_scan"] = 0


def ssd_state_scan(decay: torch.Tensor, states: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """decay f32 [B, nc, H], chunk states f32 [B, nc, H, N, hd], h0 f32
    [B, H, N, hd] or None (zeros) -> (h_starts f32 [B, nc, H, N, hd],
    h_final f32 [B, H, N, hd])."""
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
    if route("ssd_state_scan", states.device) == "plain":
        return ssd_state_scan_plain(decay, states, h0)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_state_scan: the kernel takes contiguous "
                         "tensors")
    h_starts = torch.empty_like(states)
    h_final = torch.empty((b, nh, n, hd), dtype=torch.float32,
                          device=states.device)
    fn = entry("ssd_scan", "repro_ssd_state_scan", _ARGS)
    with torch.cuda.device(states.device):
        stream = torch.cuda.current_stream(states.device).cuda_stream
        rc = fn(decay.data_ptr(), states.data_ptr(),
                None if h0 is None else h0.data_ptr(), h_starts.data_ptr(),
                h_final.data_ptr(), b, nc, nh, n * hd, stream)
    raise_on(rc, "ssd_state_scan")
    LAUNCHES["ssd_state_scan"] += 1
    return h_starts, h_final
