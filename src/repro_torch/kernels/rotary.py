"""Rotary position embedding on interleaved pairs: the port's kernel S5.

``rotary(q, k, positions, rope_frac, theta, freqs=None)`` is
``models/layers.py``'s ``apply_rope`` of q and of k in one launch (k may be
None: one tensor, as MLA rotates its query and key parts apart).  It
rotates the leading ``rot = int(hd * rope_frac) // 2 * 2`` elements of each
head in pairs (2i, 2i + 1) by ``position / theta^(2i / rot)``, or by
``position * freqs[i]`` where a table is given (f32 [rot / 2] on the
tensors' device: YaRN's, ``models/mla.py``), and copies the rest; with rot 0
the inputs come back as they are.  It is a new kernel, not a port of a TPU
kernel (the JAX package leaves the expression to XLA).

A CPU tensor runs the plain version (``ref.rotary_plain`` a tensor, the
expression as it was), a CUDA tensor runs ``csrc/rotary.cu`` or raises, and
a meta tensor gets empty outputs of the kernel's shapes.  Every route books
the call's ``cost.py`` count; ``LAUNCHES`` counts kernel launches only.  On
the card the output is bitwise the eager expression's (the kernel's note
says how).  The kernel reads the positions on the device (no host read),
writes fresh contiguous outputs, launches on the current stream and
allocates nothing itself, so a CUDA graph captures it.

q [B, S, H, hd] and k [B, S, Hk, hd] may be views whose heads have any
strides, as long as each head's elements are contiguous; positions
(int32 or int64) broadcast to [B, S].
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import cost
from .build import dtype_code, entry, raise_on, refuse_grad, route
from .ref import rotary_plain

__all__ = ["rotary", "rotary_plain", "rotated_dims", "LAUNCHES",
           "reset_launches"]

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"rotary": 0}

_c = ctypes
_ARGS = ([_c.c_int] * 3 + [_c.c_void_p] + [_c.c_longlong] * 3 + [_c.c_int]
         + [_c.c_void_p] + [_c.c_longlong] * 3 + [_c.c_int]
         + [_c.c_void_p] + [_c.c_longlong] * 2 + [_c.c_void_p] * 3
         + [_c.c_int] * 4 + [_c.c_float, _c.c_void_p])

_POS_CODE = {torch.int32: 0, torch.int64: 1}


def reset_launches():
    LAUNCHES["rotary"] = 0


def rotated_dims(hd: int, rope_frac: float) -> int:
    """The leading elements of a head that rotate."""
    return int(hd * rope_frac) // 2 * 2


def _check(q, k, positions):
    if q.dim() != 4:
        raise ValueError(f"rotary: q [B, S, H, hd], got {tuple(q.shape)}")
    b, s, _, hd = q.shape
    if k is not None:
        if k.dim() != 4 or (k.shape[0], k.shape[1], k.shape[3]) != (b, s, hd):
            raise ValueError(f"rotary: k {tuple(k.shape)} against q "
                             f"{tuple(q.shape)}")
        if k.dtype != q.dtype or k.device != q.device:
            raise ValueError("rotary: q and k of one dtype and device")
    if positions.device != q.device:
        raise ValueError("rotary: positions on another device")
    # by hand: torch.broadcast_shapes imports the symbolic-shape machinery
    # (and sympy) on its first call, seconds inside a serve's first tick
    dims = tuple(positions.shape)
    if len(dims) > 2 or any(n not in (1, want) for n, want in
                            zip(reversed(dims), (s, b))):
        raise ValueError(f"rotary: positions {dims} do not broadcast to "
                         f"[B, S] = {(b, s)}")


def _wide(t: torch.Tensor) -> bool:
    """16-byte chunks reach every head of t."""
    size = t.element_size()
    return t.shape[-1] % (16 // size) == 0 and t.data_ptr() % 16 == 0 and \
        all((st * size) % 16 == 0 for st in t.stride()[:-1])


def rotary(q: torch.Tensor, k: Optional[torch.Tensor], positions: torch.Tensor,
           rope_frac: float, theta: float,
           freqs: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """q [B, S, H, hd], k [B, S, Hk, hd] or None (f32 or bf16); positions
    [B, S] (or broadcasting to it); ``freqs`` None or f32 [rot / 2] ->
    (q', k'), fresh and contiguous, or the inputs themselves where nothing
    rotates."""
    _check(q, k, positions)
    b, s, h, hd = q.shape
    rot = rotated_dims(hd, rope_frac)
    if rot == 0:
        return q, k
    if freqs is not None and (
            freqs.dtype != torch.float32 or tuple(freqs.shape) != (rot // 2,)
            or freqs.device != q.device):
        raise ValueError(f"rotary: freqs f32 [{rot // 2}] on {q.device}, got "
                         f"{freqs.dtype} {tuple(freqs.shape)} on "
                         f"{freqs.device}")
    tensors = (q,) if k is None else (q, k)
    heads = h + (0 if k is None else k.shape[2])
    how = route("rotary", q.device)
    count = cost.rotary(b, s, heads, hd, rot, q.dtype, len(tensors),
                        positions.element_size())
    if how == "plain":
        out = cost.run_plain("rotary", count, lambda: tuple(
            rotary_plain(t, positions, rope_frac, theta, freqs)
            for t in tensors))
        return out[0], (None if k is None else out[1])
    refuse_grad("rotary", q, k)
    code = dtype_code("rotary", q.dtype)
    if positions.dtype not in _POS_CODE:
        raise TypeError(f"rotary: int32 or int64 positions, got "
                        f"{positions.dtype}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("rotary: each head's elements must be contiguous")
    pos = positions.expand(b, s)
    vec = all(_wide(t) for t in tensors)
    outs = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for t in tensors)
    cost.book("rotary", count)
    q_out, k_out = outs[0], (None if k is None else outs[1])
    if how == "meta":
        return q_out, k_out
    fn = entry("rotary", "repro_rotary", _ARGS)
    ks = (0, 0, 0) if k is None else k.stride()[:3]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(code, int(vec), _POS_CODE[pos.dtype], q.data_ptr(),
                *q.stride()[:3], h, None if k is None else k.data_ptr(),
                *ks, 0 if k is None else k.shape[2], pos.data_ptr(),
                *pos.stride(),
                None if freqs is None else freqs.contiguous().data_ptr(),
                q_out.data_ptr(),
                None if k is None else k_out.data_ptr(), b, s, hd, rot,
                theta, stream)
    raise_on(rc, "rotary")
    LAUNCHES["rotary"] += 1
    return q_out, k_out
