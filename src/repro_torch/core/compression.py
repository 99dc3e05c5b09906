"""Stream codecs for inter-device transmission — port of
``src/repro/core/compression.py`` (``none``, ``quant8``, ``sparse[:d]``).

Codecs operate on whole StreamBuffers and report *wire bytes*, computed
from static payload shapes (``wire_nbytes``, no device sync).  The compute
is the K1–K4 kernels behind ``repro_torch.kernels.ops``.

Meta contract: ``encode`` stamps ``meta["codec"]`` on the wire buffer and
``decode`` strips it again — a decoded frame never claims to be encoded.
Sparse encoding is capacity-bounded (block-COO): when the true nonzero
count exceeds the requested density the tail is dropped, and that loss is
accounted — ``meta["sparse_dropped"]`` on the wire buffer and the
process-wide :func:`codec_stats`.  The dropped counts stay on the device
per tensor; each call (or flush) syncs them to the host once.

Three call layers share the same numerics bitwise:

* per-frame :func:`encode` / :func:`decode`;
* :func:`encode_stacked` / :func:`decode_stacked` on a leading frame axis
  (one kernel launch per tensor position) — what the fused serve path runs;
* :func:`encode_batch` / :func:`decode_batch` over same-structure frames:
  stack, one stacked launch per tensor position, one truncation sync, then
  per-frame slices.  The JAX package fetches each group to the host once
  here; the port keeps frames and wire payloads on the device, where a
  slice of the stacked result is a free view.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels.ref import SPARSE_B
from .buffers import (Quant8Payload, SparsePayload, StreamBuffer,
                      stack_buffers, unstack_buffers)
from .formats import TORCH_DTYPES, dtype_name, saturating_cast

__all__ = ["encode", "decode", "encode_stacked", "decode_stacked",
           "encode_batch", "decode_batch", "wire_nbytes", "CODECS",
           "codec_stats", "reset_codec_stats", "account_sparse_dropped"]

CODECS = ("none", "quant8", "sparse")

#: meta keys describing the WIRE form of a buffer (stamped by encode,
#: stripped by decode)
_WIRE_META = ("codec", "sparse_dropped")

# process-wide lossy-encode accounting (Runtime.stats and tests read it)
_CODEC_STATS = {"sparse_truncated_tensors": 0, "sparse_dropped_values": 0}


def codec_stats() -> Dict[str, int]:
    return dict(_CODEC_STATS)


def reset_codec_stats():
    for k in _CODEC_STATS:
        _CODEC_STATS[k] = 0


def account_sparse_dropped(per_tensor) -> int:
    """Fold host-side per-tensor dropped counts into the codec stats;
    returns the total dropped values."""
    per_tensor = [int(d) for d in per_tensor]
    total = sum(per_tensor)
    if total:
        _CODEC_STATS["sparse_truncated_tensors"] += \
            sum(1 for d in per_tensor if d)
        _CODEC_STATS["sparse_dropped_values"] += total
    return total


# ---------------------------------------------------------------------------
# per-tensor codec primitives (no host syncs)
# ---------------------------------------------------------------------------

def _view2d(shape: Tuple[int, ...]) -> Tuple[int, int]:
    """Logical 2-d view of one frame (the rules of ``kernels.ops._as2d``)."""
    if len(shape) == 0:
        return (1, 1)
    if len(shape) == 1:
        return (1, int(shape[0]))
    return (int(np.prod(shape[:-1])), int(shape[-1]))


def _quant8_enc(x: torch.Tensor) -> Quant8Payload:
    q, scale = kops.quantize8(x)
    shape = tuple(x.shape)
    return Quant8Payload(q=q, scale=scale, dtype=dtype_name(x.dtype),
                         shape=shape, view2d=_view2d(shape))


def _quant8_dec(enc: Quant8Payload) -> torch.Tensor:
    x = kops.dequantize8(enc.q, enc.scale)
    m, n = enc.view2d
    return saturating_cast(x[:m, :n], TORCH_DTYPES[enc.dtype]).reshape(
        enc.shape)


def _sparse_cap(size: int, density: float) -> int:
    """Block-COO capacity for ``size`` elements at ``density``.
    ``density >= 1.0`` is lossless: every block gets full capacity (an even
    spread of ``size * density`` would under-allocate a block when
    ``size`` is not a multiple of the block)."""
    if density >= 1.0:
        nb = max(1, -(-size // SPARSE_B))
        return nb * SPARSE_B
    return max(1, int(size * density))


def _sparse_enc(x: torch.Tensor, density: float = 0.25
                ) -> Tuple[SparsePayload, torch.Tensor]:
    """-> (payload, dropped): ``dropped`` counts the true nonzeros the
    capacity could not carry, kept on the device."""
    cap = _sparse_cap(x.numel(), density)
    flat = x.reshape(-1)
    # the codec encodes at threshold 0.0, so the kernel's uncapped count of
    # |x| > 0 is the reference's true_nnz
    values, indices, nnz, true_nnz = kops.sparse_enc(flat, cap, 0.0,
                                                     with_total=True)
    dropped = (true_nnz - nnz).clamp_min(0)
    return SparsePayload(values=values, indices=indices, nnz=nnz,
                         dense_shape=tuple(x.shape)), dropped


def _sparse_dec(sp: SparsePayload) -> torch.Tensor:
    n = int(np.prod(sp.dense_shape))
    return kops.sparse_dec(sp.values, sp.indices, sp.nnz,
                              n).reshape(sp.dense_shape)


# ---------------------------------------------------------------------------
# stacked codec primitives (leading frame axis)
# ---------------------------------------------------------------------------

def _quant8_enc_stacked(x: torch.Tensor) -> Quant8Payload:
    q, scale = kops.quantize8_stacked(x)
    fshape = tuple(x.shape[1:])
    return Quant8Payload(q=q, scale=scale, dtype=dtype_name(x.dtype),
                         shape=fshape, view2d=_view2d(fshape))


def _quant8_dec_stacked(enc: Quant8Payload) -> torch.Tensor:
    b = enc.q.shape[0]
    x = kops.dequantize8_stacked(enc.q, enc.scale)
    m, n = enc.view2d
    return saturating_cast(x[:, :m, :n], TORCH_DTYPES[enc.dtype]).reshape(
        (b,) + tuple(enc.shape))


def _sparse_enc_stacked(x: torch.Tensor, density: float
                        ) -> Tuple[SparsePayload, torch.Tensor]:
    """[B, *shape] -> (stacked payload, dropped int32 [B])."""
    fshape = tuple(x.shape[1:])
    size = int(np.prod(fshape)) if fshape else 1
    cap = _sparse_cap(size, density)
    flat = x.reshape(x.shape[0], size)
    # threshold 0.0: the kernel's uncapped counts are the true nonzeros
    values, indices, nnz, true_nnz = kops.sparse_enc_stacked(
        flat, cap, 0.0, with_total=True)
    dropped = (true_nnz - nnz).clamp_min(0)
    return SparsePayload(values=values, indices=indices, nnz=nnz,
                         dense_shape=fshape), dropped


def _sparse_dec_stacked(sp: SparsePayload) -> torch.Tensor:
    b = sp.values.shape[0]
    n = int(np.prod(sp.dense_shape))
    dense = kops.sparse_dec_stacked(sp.values, sp.indices, sp.nnz, n)
    return dense.reshape((b,) + tuple(sp.dense_shape))


# ---------------------------------------------------------------------------
# wire-bytes accounting (static shapes; no syncs)
# ---------------------------------------------------------------------------

def _payload_nbytes(t) -> int:
    if isinstance(t, (Quant8Payload, SparsePayload)):
        return t.wire_nbytes
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    a = np.asarray(t)
    return a.size * a.dtype.itemsize


def wire_nbytes(buf: StreamBuffer) -> int:
    """Wire bytes of an encoded buffer, from static payload shapes only."""
    return sum(_payload_nbytes(t) for t in buf.tensors)


def _strip_wire_meta(meta: Dict) -> Dict:
    return {k: v for k, v in meta.items() if k not in _WIRE_META}


def _density(arg: str) -> float:
    return float(arg) if arg else 0.25


# ---------------------------------------------------------------------------
# per-frame API
# ---------------------------------------------------------------------------

def encode(buf: StreamBuffer, codec: str) -> Tuple[StreamBuffer, int]:
    """Returns (encoded buffer, wire bytes).  ``codec`` may carry a
    parameter: "sparse:0.15" bounds the COO capacity at 15% density."""
    base, _, arg = codec.partition(":")
    if base == "none":
        return buf, buf.nbytes()
    if base == "quant8":
        enc = tuple(_quant8_enc(t) for t in buf.tensors)
        out = buf.with_(tensors=enc, meta={**buf.meta, "codec": "quant8"})
        return out, wire_nbytes(out)
    if base == "sparse":
        density = _density(arg)
        pairs = tuple(_sparse_enc(t, density) for t in buf.tensors)
        meta = {**buf.meta, "codec": "sparse"}
        # one host sync for the whole call
        dropped = account_sparse_dropped(
            torch.stack([d for _, d in pairs]).cpu().numpy())
        if dropped:
            meta["sparse_dropped"] = dropped
        out = buf.with_(tensors=tuple(p for p, _ in pairs), meta=meta)
        return out, wire_nbytes(out)
    raise ValueError(f"unknown codec {codec!r}")


def decode(buf: StreamBuffer, codec: str) -> StreamBuffer:
    base, _, _ = codec.partition(":")
    if base == "none":
        return buf
    if base == "quant8":
        tensors = tuple(_quant8_dec(e) for e in buf.tensors)
    elif base == "sparse":
        tensors = tuple(_sparse_dec(e) for e in buf.tensors)
    else:
        raise ValueError(f"unknown codec {codec!r}")
    return buf.with_(tensors=tensors, meta=_strip_wire_meta(buf.meta))


# ---------------------------------------------------------------------------
# stacked API (what the fused serve path runs)
# ---------------------------------------------------------------------------

def encode_stacked(buf: StreamBuffer, codec: str
                   ) -> Tuple[StreamBuffer, Optional[torch.Tensor]]:
    """Encode a STACKED buffer (leading frame axis) with one kernel launch
    per tensor.  Returns (stacked wire buffer, dropped int32 [tensors,
    frames] on the device, or None); frame ``i`` of every payload is
    bitwise ``encode(frame_i)``'s.  ``meta["sparse_dropped"]`` is not
    stamped here: the caller syncs once per flush and stamps per frame."""
    base, _, arg = codec.partition(":")
    if base == "none":
        return buf, None
    if base == "quant8":
        enc = tuple(_quant8_enc_stacked(t) for t in buf.tensors)
        return buf.with_(tensors=enc,
                         meta={**buf.meta, "codec": "quant8"}), None
    if base == "sparse":
        density = _density(arg)
        pairs = tuple(_sparse_enc_stacked(t, density) for t in buf.tensors)
        dropped = torch.stack([d for _, d in pairs])     # [tensors, frames]
        return buf.with_(tensors=tuple(p for p, _ in pairs),
                         meta={**buf.meta, "codec": "sparse"}), dropped
    raise ValueError(f"unknown codec {codec!r}")


def decode_stacked(buf: StreamBuffer, codec: str) -> StreamBuffer:
    """Decode a STACKED wire buffer with one kernel launch per tensor;
    frame ``i`` is bitwise ``decode(frame_i)``."""
    base, _, _ = codec.partition(":")
    if base == "none":
        return buf
    if base == "quant8":
        tensors = tuple(_quant8_dec_stacked(e) for e in buf.tensors)
    elif base == "sparse":
        tensors = tuple(_sparse_dec_stacked(e) for e in buf.tensors)
    else:
        raise ValueError(f"unknown codec {codec!r}")
    return buf.with_(tensors=tensors, meta=_strip_wire_meta(buf.meta))


# ---------------------------------------------------------------------------
# batch helpers (one stacked launch per tensor position per group)
# ---------------------------------------------------------------------------

def _stacked(bufs: Sequence[StreamBuffer]) -> StreamBuffer:
    return StreamBuffer(tensors=stack_buffers([b.tensors for b in bufs]))


def encode_batch(bufs: Sequence[StreamBuffer], codec: str
                 ) -> List[Tuple[StreamBuffer, int]]:
    """Batched :func:`encode` over same-structure frames: one stacked
    launch per tensor position and one truncation sync for the batch.
    Element ``i`` is bitwise ``encode(bufs[i])`` (payloads, meta —
    ``sparse_dropped`` included — and wire bytes)."""
    bufs = list(bufs)
    if not bufs:
        return []
    base, _, _ = codec.partition(":")
    if base == "none":
        return [(b, b.nbytes()) for b in bufs]
    wire, dropped = encode_stacked(_stacked(bufs), codec)
    per_tensor = None if dropped is None else dropped.cpu().numpy()
    frames = unstack_buffers(wire.tensors, len(bufs))
    out = []
    for i, (buf, tensors) in enumerate(zip(bufs, frames)):
        meta = {**buf.meta, "codec": base}
        if per_tensor is not None:
            frame_dropped = account_sparse_dropped(per_tensor[:, i])
            if frame_dropped:
                meta["sparse_dropped"] = frame_dropped
        enc = buf.with_(tensors=tuple(tensors), meta=meta)
        out.append((enc, wire_nbytes(enc)))
    return out


def decode_batch(bufs: Sequence[StreamBuffer], codec: str
                 ) -> List[StreamBuffer]:
    """Batched :func:`decode` over same-structure wire frames: one stacked
    launch per tensor position.  Element ``i`` is bitwise
    ``decode(bufs[i])``."""
    bufs = list(bufs)
    if not bufs:
        return []
    base, _, _ = codec.partition(":")
    if base == "none":
        return bufs
    dec = decode_stacked(_stacked(bufs), codec)
    frames = unstack_buffers(dec.tensors, len(bufs))
    return [b.with_(tensors=tuple(t), meta=_strip_wire_meta(b.meta))
            for b, t in zip(bufs, frames)]
