"""Public entry points over the wire-codec kernels K1–K4 — port of
``src/repro/kernels/ops.py``.

Handles shape canonicalization (padding to (32, 128) tiles and 512-element
blocks) and the block-COO capacity bookkeeping; the kernel wrappers
(``quant8``, ``sparse_enc``, ``sparse_dec``) pick the CUDA kernel or the
plain version by the tensors' device, so there is no ``impl=`` knob here.

Stacked entry points (``*_stacked``): the codecs' framing is local — quant8
scales live per (32, 128) tile and sparse slots per 512-element block — so
a batch of same-shape frames encodes in ONE kernel launch per tensor by
merging the frame axis into the tile-row or block axis (frame boundaries
land on tile/block boundaries by construction).  Frame ``i`` of a stacked
call is bitwise the per-frame call.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import quant8 as _q8
from .ref import QUANT_BM, QUANT_BN, SPARSE_B, _sparse_dims
from .sparse_dec import sparse_dec as _sparse_dec
from .sparse_enc import sparse_enc as _sparse_enc

__all__ = ["quantize8", "dequantize8", "sparse_enc", "sparse_dec",
           "quantize8_stacked", "dequantize8_stacked", "sparse_enc_stacked",
           "sparse_dec_stacked"]


def _as2d(x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 0:
        return x.reshape(1, 1)
    if x.dim() == 1:
        return x.reshape(1, -1)
    if x.dim() > 2:
        return x.reshape(-1, x.shape[-1])
    return x


def _pad_tiles(x2: torch.Tensor) -> torch.Tensor:
    m, n = x2.shape[-2:]
    pm, pn = (-m) % QUANT_BM, (-n) % QUANT_BN
    if pm or pn:
        x2 = F.pad(x2, (0, pn, 0, pm))
    return x2.contiguous()


def quantize8(x: torch.Tensor):
    """Any-shape float tensor -> (q int8 [Mp, Np], scales f32 [Mp/32,
    Np/128]); the original shape is the caller's to remember."""
    return _q8.quantize8(_pad_tiles(_as2d(x.to(torch.float32))))


def dequantize8(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return _q8.dequantize8(q, scales)


def quantize8_stacked(x: torch.Tensor):
    """Stacked frames [B, *shape] -> (q int8 [B, Mp, Np], scales [B, Mp/32,
    Np/128]) in one launch; frame i is bitwise ``quantize8(x[i])``."""
    b = x.shape[0]
    fshape = x.shape[1:]
    if len(fshape) == 0:
        x3 = x.reshape(b, 1, 1)
    elif len(fshape) == 1:
        x3 = x.reshape(b, 1, fshape[0])
    else:
        x3 = x.reshape(b, -1, fshape[-1])
    x3 = _pad_tiles(x3.to(torch.float32))
    _, mp, np_ = x3.shape
    q, s = _q8.quantize8(x3.reshape(b * mp, np_))
    return (q.reshape(b, mp, np_),
            s.reshape(b, mp // QUANT_BM, np_ // QUANT_BN))


def dequantize8_stacked(q: torch.Tensor, scales: torch.Tensor
                        ) -> torch.Tensor:
    """Inverse of :func:`quantize8_stacked`: one launch, bitwise
    per-frame."""
    b, mp, np_ = q.shape
    _, gm, gn = scales.shape
    x = _q8.dequantize8(q.reshape(b * mp, np_).contiguous(),
                        scales.reshape(b * gm, gn).contiguous())
    return x.reshape(b, mp, np_)


def sparse_enc(flat: torch.Tensor, cap: int, threshold: float = 0.0,
               with_total: bool = False):
    """flat [N] -> (values [nb*kb], indices int32 [nb*kb], nnz int32
    scalar); kb follows from ``cap`` by ``_sparse_dims``.  ``with_total``
    adds the uncapped count of |x| > threshold, an int32 scalar, from the
    same launch."""
    n = int(flat.shape[0])
    nb, kb = _sparse_dims(n, cap)
    pad = nb * SPARSE_B - n
    if pad:
        flat = F.pad(flat, (0, pad))
    out = _sparse_enc(flat.contiguous(), kb=kb, threshold=threshold,
                      totals=with_total)
    return out[:2] + tuple(c.sum(dtype=torch.int32) for c in out[2:])


def sparse_enc_stacked(x: torch.Tensor, cap: int, threshold: float = 0.0,
                       with_total: bool = False):
    """Stacked flat frames [B, N] -> (values [B, nb*kb], indices [B, nb*kb],
    nnz int32 [B]) in one launch; frame i is bitwise ``sparse_enc(x[i])``
    (the kernel writes each frame's own flat coordinates).  ``with_total``
    adds the uncapped counts, int32 [B]."""
    b, n = x.shape
    nb, kb = _sparse_dims(n, cap)
    pad = nb * SPARSE_B - n
    if pad:
        x = F.pad(x, (0, pad))
    out = _sparse_enc(x.reshape(-1).contiguous(), kb=kb, threshold=threshold,
                      frame_blocks=nb, totals=with_total)
    return (out[0].reshape(b, nb * kb), out[1].reshape(b, nb * kb)) + tuple(
        c.reshape(b, nb).sum(dim=1, dtype=torch.int32) for c in out[2:])


def sparse_dec(values: torch.Tensor, indices: torch.Tensor, nnz, n: int
               ) -> torch.Tensor:
    """Block-COO -> dense flat [n]."""
    del nnz  # empty slots hold zeros, so the scatter needs no count
    nb = -(-n // SPARSE_B)
    kb = int(values.shape[0]) // nb
    dense = _sparse_dec(values.reshape(nb, kb).contiguous(),
                        indices.reshape(nb, kb).contiguous())
    return dense[:n]


def sparse_dec_stacked(values: torch.Tensor, indices: torch.Tensor, nnz,
                       n: int) -> torch.Tensor:
    """Stacked block-COO [B, nb*kb] -> dense [B, n], one launch, bitwise
    per-frame (inverse of :func:`sparse_enc_stacked`)."""
    del nnz
    b, total = values.shape
    nb = -(-n // SPARSE_B)
    kb = total // nb
    off = (torch.arange(b, dtype=torch.int32, device=values.device)
           * (nb * SPARSE_B))[:, None]
    dense = _sparse_dec(values.reshape(b * nb, kb).contiguous(),
                        (indices + off).reshape(b * nb, kb))
    return dense.reshape(b, nb * SPARSE_B)[:, :n]
