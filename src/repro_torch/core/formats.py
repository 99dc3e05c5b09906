"""Tensor stream data types — the ``other/tensors`` media type (paper §4.1).

Port of ``src/repro/core/formats.py``: caps, tensor specs and the on-wire
dtype tags, with each tag mapped to a torch dtype.  Formats:

* STATIC   — plain tensor, schema fixed at caps-negotiation time.
* FLEXIBLE — max-capacity padded tensor + per-frame header.
* SPARSE   — fixed-capacity COO triple (the codec payloads wait for slice 2).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "TensorFormat", "TensorSpec", "Caps", "CapsError",
    "DTYPE_TAGS", "TORCH_DTYPES", "dtype_to_tag", "tag_to_dtype",
    "dtype_name",
]


class TensorFormat(enum.Enum):
    STATIC = "static"
    FLEXIBLE = "flexible"
    SPARSE = "sparse"


# Stable on-the-wire dtype tags (NNStreamer's tensor_typedef analogue) —
# the same tags, in the same order, as the JAX package.
DTYPE_TAGS: Tuple[str, ...] = (
    "int8", "uint8", "int16", "uint16", "int32", "uint32",
    "int64", "uint64", "float16", "float32", "float64", "bfloat16",
)

TORCH_DTYPES = {
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "uint16": torch.uint16, "int32": torch.int32, "uint32": torch.uint32,
    "int64": torch.int64, "uint64": torch.uint64, "float16": torch.float16,
    "float32": torch.float32, "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}


def dtype_name(dtype) -> str:
    """Tag name of a torch dtype, numpy dtype or name string."""
    if isinstance(dtype, str):
        return dtype
    if isinstance(dtype, torch.dtype):
        return str(dtype).rpartition(".")[2]
    return np.dtype(dtype).name


def dtype_to_tag(dtype) -> int:
    name = dtype_name(dtype)
    try:
        return DTYPE_TAGS.index(name)
    except ValueError as e:
        raise CapsError(f"unsupported stream dtype {name!r}") from e


def tag_to_dtype(tag: int) -> torch.dtype:
    return TORCH_DTYPES[DTYPE_TAGS[int(tag)]]


class CapsError(ValueError):
    """Raised when caps negotiation between two pads fails (link-time error)."""


# NNStreamer limits tensors to rank<=4 on the wire ("4:20:1:1" style dims).
MAX_RANK = 4


@dataclass(frozen=True)
class TensorSpec:
    """Schema of one tensor in a stream frame (frame shape, no batch dim).
    For FLEXIBLE, ``shape`` is the maximum capacity; for SPARSE, the dense
    logical shape with ``max_nnz`` bounding the coordinate list."""

    shape: Tuple[int, ...]
    dtype: str = "float32"
    format: TensorFormat = TensorFormat.STATIC
    max_nnz: Optional[int] = None

    def __post_init__(self):
        if len(self.shape) > MAX_RANK:
            raise CapsError(f"rank {len(self.shape)} > {MAX_RANK}: {self.shape}")
        if self.format == TensorFormat.SPARSE and self.max_nnz is None:
            object.__setattr__(self, "max_nnz", int(np.prod(self.shape)))
        dtype_to_tag(self.dtype)  # validate

    @property
    def nelem(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self) -> int:
        return self.nelem * TORCH_DTYPES[self.dtype].itemsize

    def with_format(self, fmt: TensorFormat) -> "TensorSpec":
        return replace(self, format=fmt)

    def compatible(self, other: "TensorSpec") -> bool:
        """Can a producer of `self` feed a consumer expecting `other`?"""
        if self.format != other.format:
            return False
        if self.format == TensorFormat.FLEXIBLE:
            return self.nelem <= other.nelem
        if self.dtype != other.dtype:
            return False
        if self.format == TensorFormat.SPARSE:
            return self.shape == other.shape and self.max_nnz <= (other.max_nnz or 0)
        return self.shape == other.shape

    def describe(self) -> str:
        dims = ":".join(str(d) for d in self.shape) or "1"
        s = f"{dims},{self.dtype}"
        if self.format != TensorFormat.STATIC:
            s += f",format={self.format.value}"
        return s


@dataclass(frozen=True)
class Caps:
    """GStreamer-caps analogue for a pad: media type + per-tensor schemas
    ("other/tensors", "other/flexbuf", "video/x-raw", "any")."""

    media: str = "other/tensors"
    tensors: Tuple[TensorSpec, ...] = field(default_factory=tuple)

    ANY: "Caps" = None  # set below

    @property
    def num_tensors(self) -> int:
        return len(self.tensors)

    def is_any(self) -> bool:
        return self.media == "any"

    def intersect(self, other: "Caps") -> "Caps":
        """Link-time negotiation: producer caps ∩ consumer template."""
        if self.is_any():
            return other
        if other.is_any():
            return self
        if self.media != other.media:
            raise CapsError(f"media mismatch: {self.media} vs {other.media}")
        if other.tensors and self.tensors:
            if len(self.tensors) != len(other.tensors):
                raise CapsError(
                    f"num_tensors mismatch: {len(self.tensors)} vs {len(other.tensors)}")
            for i, (a, b) in enumerate(zip(self.tensors, other.tensors)):
                if not a.compatible(b):
                    raise CapsError(
                        f"tensor {i} incompatible: {a.describe()} vs {b.describe()}")
            return self
        return self if self.tensors else other

    def describe(self) -> str:
        if self.is_any():
            return "ANY"
        parts = [self.media, f"num_tensors={self.num_tensors}"]
        parts += [t.describe() for t in self.tensors]
        return ", ".join(parts)


Caps.ANY = Caps(media="any")
