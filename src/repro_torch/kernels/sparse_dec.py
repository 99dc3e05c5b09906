"""Block-COO sparse decode (``tensor_sparse_dec``, the sparse wire codec): K4.

Port of ``sparse_dec_pallas`` in ``src/repro/kernels/sparse_dec.py``.  The
wrapper dispatches on the tensors' device: CPU tensors run the plain
version (``ref.sparse_dec_plain``), CUDA tensors run the hand-written kernel
in ``csrc/sparse_dec.cu`` or raise, meta tensors get an empty output of
the kernel's shape.  Every route books the call's ``cost.py`` count.
``LAUNCHES`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import cost
from .build import dtype_code, entry, raise_on, refuse_grad, route
from .ref import SPARSE_B, sparse_dec_plain

__all__ = ["sparse_dec", "LAUNCHES", "reset_launches"]

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"sparse_dec": 0}

_c = ctypes
_DEC_ARGS = [_c.c_int] + [_c.c_void_p] * 3 + [_c.c_int] * 2 + [_c.c_void_p]


def reset_launches():
    LAUNCHES["sparse_dec"] = 0


def sparse_dec(v2: torch.Tensor, i2: torch.Tensor) -> torch.Tensor:
    """values/indices [nb, kb] block-COO -> dense [nb*512] in the values'
    dtype (block b owns indices [b*512, (b+1)*512))."""
    if v2.dim() != 2 or tuple(i2.shape) != tuple(v2.shape) or \
            i2.dtype != torch.int32 or v2.shape[1] < 1:
        raise ValueError(f"sparse_dec: values/indices [nb, kb] (int32 "
                         f"indices) required, got {tuple(v2.shape)} / "
                         f"{tuple(i2.shape)} {i2.dtype}")
    how = route("sparse_dec", v2.device)
    count = cost.sparse_dec(v2.shape[0], v2.shape[1], v2.dtype)
    if how == "plain":
        return cost.run_plain("sparse_dec", count, sparse_dec_plain, v2, i2)
    refuse_grad("sparse_dec", v2)
    code = dtype_code("sparse_dec", v2.dtype)
    if i2.device != v2.device or not (v2.is_contiguous() and
                                      i2.is_contiguous()):
        raise ValueError("sparse_dec kernel: contiguous values and indices "
                         "on one device required")
    nb, kb = v2.shape
    out = torch.empty(nb * SPARSE_B, dtype=v2.dtype, device=v2.device)
    cost.book("sparse_dec", count)
    if how == "meta":
        return out
    fn = entry("sparse_dec", "repro_sparse_dec", _DEC_ARGS)
    with torch.cuda.device(v2.device):
        stream = torch.cuda.current_stream(v2.device).cuda_stream
        rc = fn(code, v2.data_ptr(), i2.data_ptr(),
                out.data_ptr(), nb, kb, stream)
    raise_on(rc, "sparse_dec")
    LAUNCHES["sparse_dec"] += 1
    return out
