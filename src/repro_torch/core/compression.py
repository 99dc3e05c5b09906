"""Stream codecs for inter-device transmission — the ``none`` codec of
``src/repro/core/compression.py``.

Codecs operate on whole StreamBuffers and report wire bytes.  Meta
contract (as in the JAX package): ``encode`` stamps ``meta["codec"]`` on a
really-encoded wire buffer and ``decode`` strips it.  ``none`` is the
identity both ways, so a model-serving request — whose int32 prompt tokens
no lossy codec should touch — crosses the wire unchanged.  ``quant8`` and
``sparse`` (the K1–K4 kernels) come with slice 2 and raise until then.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .buffers import StreamBuffer

__all__ = ["encode", "decode", "encode_batch", "decode_batch", "wire_nbytes",
           "CODECS"]

CODECS = ("none", "quant8", "sparse")

#: meta keys describing the WIRE form of a buffer (stamped by encode,
#: stripped by decode)
_WIRE_META = ("codec", "sparse_dropped")


def _base(codec: str) -> str:
    base, _, _ = codec.partition(":")
    if base in ("quant8", "sparse"):
        raise NotImplementedError(
            f"codec {base!r}: the quant8/sparse wire codecs (kernels K1-K4) "
            f"are ROADMAP M2, slice 2 of the port")
    if base != "none":
        raise ValueError(f"unknown codec {codec!r}")
    return base


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    a = np.asarray(t)
    return a.size * a.dtype.itemsize


def wire_nbytes(buf: StreamBuffer) -> int:
    """Wire bytes of an encoded buffer, from static shapes only."""
    return sum(_nbytes(t) for t in buf.tensors)


def encode(buf: StreamBuffer, codec: str) -> Tuple[StreamBuffer, int]:
    """Returns (encoded buffer, wire bytes)."""
    _base(codec)
    return buf, buf.nbytes()


def decode(buf: StreamBuffer, codec: str) -> StreamBuffer:
    _base(codec)
    return buf


def encode_batch(bufs: Sequence[StreamBuffer], codec: str
                 ) -> List[Tuple[StreamBuffer, int]]:
    """Batched :func:`encode` over same-structure frames; element ``i`` is
    ``encode(bufs[i])``."""
    _base(codec)
    return [(b, b.nbytes()) for b in bufs]


def decode_batch(bufs: Sequence[StreamBuffer], codec: str
                 ) -> List[StreamBuffer]:
    _base(codec)
    return list(bufs)
