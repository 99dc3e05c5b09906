"""NNStreamer-Edge analogue: a minimal, numpy-only client library.

Port of ``src/repro/edge/edge.py``.  Devices that cannot afford a pipeline
runtime still interoperate: an RTOS sensor publishes tensor streams
("edge_sensor"), a display subscribes ("edge_output"), a plain Python
process offloads inference ("edge_query_client").  The module imports only
numpy and stdlib at module scope and speaks the same wire format (packed
header + raw bytes) as the JAX package, byte for byte.

Wire format (little-endian):
  magic 'NNSE' | version u16 | num_tensors u16 | pts i64
  per tensor: dtype_tag u16 | ndim u16 | dims u32[ndim] | nbytes u64 | raw
  v2 appends: crc32 u32 over every preceding byte

Version 2 adds the CRC32 trailer (the lossy-transport fault model,
DESIGN.md §10): structure checks catch protocol damage, the checksum
catches bit damage.  v1 frames (no trailer) still parse.

The clients hand numpy frames to port pipelines, which may live on the
card: the receiving element (``mqttsrc``, the query batcher) places them
on its pipeline's device.  What comes back is numpy, copied off the card.
"""
from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

_MAGIC = b"NNSE"
_VERSION = 2


class ChecksumError(ValueError):
    """The frame parsed structurally but failed its CRC32 trailer — bit
    corruption in transit, distinct from protocol damage (bad magic,
    truncation, unknown dtype): a retransmit of the same frame may well
    succeed."""


_DTYPES = ("int8", "uint8", "int16", "uint16", "int32", "uint32",
           "int64", "uint64", "float16", "float32", "float64")


def pack_buffer(tensors: Sequence[np.ndarray], pts: int = 0) -> bytes:
    parts = [_MAGIC, struct.pack("<HHq", _VERSION, len(tensors), pts)]
    for t in tensors:
        # NOT ascontiguousarray: that promotes 0-dim scalars to shape (1,),
        # silently changing the tensor's rank on the wire
        t = np.asarray(t, order="C")
        tag = _DTYPES.index(t.dtype.name)
        parts.append(struct.pack("<HH", tag, t.ndim))
        parts.append(struct.pack(f"<{t.ndim}I", *t.shape) if t.ndim else b"")
        raw = t.tobytes()
        parts.append(struct.pack("<Q", len(raw)))
        parts.append(raw)
    body = b"".join(parts)
    return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)


def unpack_buffer(data: bytes) -> Tuple[List[np.ndarray], int]:
    """Strict inverse of :func:`pack_buffer`.

    Wrong protocol, a future wire version, a frame cut mid-payload or a
    bit flipped in transit all raise ``ValueError``.  Structural checks
    run FIRST and keep their specific errors; the checksum is verified
    LAST, so a frame that parses but fails its CRC raises the distinct
    :class:`ChecksumError`."""
    data = bytes(data)
    if len(data) < 16:
        raise ValueError(f"truncated header: {len(data)} bytes, need 16")
    if data[:4] != _MAGIC:
        raise ValueError("bad magic")
    ver, n, pts = struct.unpack_from("<HHq", data, 4)
    if ver == _VERSION:
        if len(data) < 20:
            raise ValueError(f"truncated checksum trailer: {len(data)} "
                             f"bytes, need 20")
        (crc,) = struct.unpack_from("<I", data, len(data) - 4)
        body = data[:-4]
    elif ver == 1:
        crc, body = None, data      # pre-§10 sender: no trailer
    else:
        raise ValueError(f"unsupported wire version {ver} (speaks {_VERSION})")
    off = 16
    tensors = []
    for i in range(n):
        if off + 4 > len(body):
            raise ValueError(f"tensor {i}: truncated tensor header")
        tag, ndim = struct.unpack_from("<HH", body, off)
        off += 4
        if tag >= len(_DTYPES):
            raise ValueError(f"tensor {i}: unknown dtype tag {tag}")
        if off + 4 * ndim + 8 > len(body):
            raise ValueError(f"tensor {i}: truncated dims/size fields")
        shape = struct.unpack_from(f"<{ndim}I", body, off) if ndim else ()
        off += 4 * ndim
        (nbytes,) = struct.unpack_from("<Q", body, off)
        off += 8
        dt = np.dtype(_DTYPES[tag])
        expected = int(np.prod(shape, dtype=np.uint64)) * dt.itemsize
        if nbytes != expected:
            raise ValueError(
                f"tensor {i}: payload size {nbytes} != shape {tuple(shape)} "
                f"x {dt.name} = {expected}")
        if off + nbytes > len(body):
            raise ValueError(f"tensor {i}: truncated payload "
                             f"({len(body) - off} of {nbytes} bytes)")
        arr = np.frombuffer(body, dtype=dt, count=nbytes // dt.itemsize,
                            offset=off).reshape(shape)
        tensors.append(arr.copy())
        off += nbytes
    if off != len(body):
        raise ValueError(f"{len(body) - off} trailing bytes after {n} tensors")
    if crc is not None and (zlib.crc32(body) & 0xFFFFFFFF) != crc:
        raise ChecksumError(
            f"checksum mismatch: trailer {crc:#010x} != computed "
            f"{zlib.crc32(body) & 0xFFFFFFFF:#010x}")
    return tensors, pts


def _to_numpy(t) -> np.ndarray:
    """A pipeline tensor as numpy: a torch tensor (on the card or not) is
    copied to the host first."""
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class EdgeSensor:
    """edge_sensor: publish tensor frames under a topic (mqttsink-compatible)."""

    def __init__(self, broker, topic: str):
        from ..core.formats import Caps
        from ..core.pubsub import Channel
        self.channel = Channel()
        self.registration = broker.register(topic, Caps(media="other/tensors"),
                                            self.channel, element="edge_sensor")

    def publish(self, tensors: Sequence[np.ndarray], pts: int = 0):
        from ..core.buffers import StreamBuffer
        wire = pack_buffer(tensors, pts)
        buf = StreamBuffer(tensors=tuple(np.asarray(t) for t in tensors),
                           pts=np.int64(pts), meta={"wire_nbytes": len(wire)})
        self.channel.push(buf, nbytes=len(wire))


class EdgeOutput:
    """edge_output: subscribe to a topic and poll frames as numpy."""

    def __init__(self, broker, topic_filter: str):
        self.binding = broker.subscribe(topic_filter)
        self._rx = self.binding.endpoint.attach_consumer()

    def poll(self) -> Optional[Tuple[List[np.ndarray], int]]:
        buf = self._rx.pop()
        if buf is None:
            return None
        return [_to_numpy(t) for t in buf.tensors], int(buf.pts)


class EdgeQueryClient:
    """edge_query_client: offload inference without running a pipeline."""

    def __init__(self, broker, operation: str):
        self.binding = broker.subscribe(f"query/{operation}")
        self.client_id = 1 << 16  # edge namespace, avoids pipeline client ids

    def infer(self, tensors: Sequence[np.ndarray]) -> List[np.ndarray]:
        from ..core.buffers import StreamBuffer
        ep = self.binding.endpoint
        buf = StreamBuffer(tensors=tuple(np.asarray(t) for t in tensors),
                           pts=np.int64(0),
                           meta={"client_id": self.client_id, "codec": "none"})
        ep.requests.push(buf)
        runner = ep.spec.get("inline_runner")
        if runner is not None:
            runner()
        out = ep.client_channel(self.client_id).pop()
        if out is None:
            raise RuntimeError("no answer from query server")
        return [_to_numpy(t) for t in out.tensors]
