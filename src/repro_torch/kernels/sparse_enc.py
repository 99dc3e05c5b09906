"""Block-COO sparse encode (``tensor_sparse_enc``, the sparse wire codec): K3.

Port of ``sparse_enc_pallas`` in ``src/repro/kernels/sparse_enc.py``.  The
wrapper dispatches on the tensor's device: a CPU tensor runs the plain
version (``ref.sparse_enc_plain``), a CUDA tensor runs the hand-written
kernel in ``csrc/sparse_enc.cu`` or raises.  ``LAUNCHES`` counts kernel
launches only.  Capacities and the stacked framing live in ``ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .build import dtype_code, entry, raise_on, route
from .ref import SPARSE_B, sparse_enc_plain

__all__ = ["sparse_enc", "LAUNCHES", "reset_launches"]

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"sparse_enc": 0}

_c = ctypes
_ENC_ARGS = ([_c.c_int] + [_c.c_void_p] * 4 + [_c.c_int] * 2
             + [_c.c_float, _c.c_void_p])


def reset_launches():
    LAUNCHES["sparse_enc"] = 0


def sparse_enc(flat: torch.Tensor, *, kb: int, threshold: float = 0.0):
    """flat [nb*512] -> (values [nb*kb] in flat's dtype, indices int32
    [nb*kb], counts int32 [nb]); ``kb`` in [1, 512]."""
    n = flat.shape[0] if flat.dim() == 1 else -1
    if n < 0 or n % SPARSE_B or not 1 <= kb <= SPARSE_B:
        raise ValueError(f"sparse_enc: flat [nb*{SPARSE_B}] and 1 <= kb <= "
                         f"{SPARSE_B} required, got {tuple(flat.shape)}, "
                         f"kb={kb}")
    if route("sparse_enc", flat.device) == "plain":
        return sparse_enc_plain(flat, kb, threshold)
    code = dtype_code("sparse_enc", flat.dtype)
    if not flat.is_contiguous():
        raise ValueError("sparse_enc kernel: contiguous input required")
    if n >= 2 ** 31:
        raise ValueError("sparse_enc kernel: int32 indices need n < 2^31")
    nb = n // SPARSE_B
    dev = flat.device
    vals = torch.empty(nb * kb, dtype=flat.dtype, device=dev)
    idxs = torch.empty(nb * kb, dtype=torch.int32, device=dev)
    cnts = torch.empty(nb, dtype=torch.int32, device=dev)
    fn = entry("sparse_enc", "repro_sparse_enc", _ENC_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(code, flat.data_ptr(), vals.data_ptr(),
                idxs.data_ptr(), cnts.data_ptr(), nb, kb, float(threshold),
                stream)
    raise_on(rc, "sparse_enc")
    LAUNCHES["sparse_enc"] += 1
    return vals, idxs, cnts
