"""Block-COO sparse encode (``tensor_sparse_enc``, the sparse wire codec): K3.

Port of ``sparse_enc_pallas`` in ``src/repro/kernels/sparse_enc.py``.  The
wrapper dispatches on the tensor's device: a CPU tensor runs the plain
version (``ref.sparse_enc_plain``), a CUDA tensor runs the hand-written
kernel in ``csrc/sparse_enc.cu`` or raises, a meta tensor gets empty
outputs of the kernel's shapes.  Every route books the call's ``cost.py``
count.  ``LAUNCHES`` counts kernel launches only, and ``ENC_ROUTE_LAUNCHES`` splits them by the kernel's load
route (:func:`enc_route`).  Capacities and the stacked framing live in
``ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import cost
from .build import dtype_code, entry, raise_on, refuse_grad, route
from .ref import SPARSE_B, sparse_enc_plain

__all__ = ["sparse_enc", "enc_route", "LAUNCHES", "ENC_ROUTE_LAUNCHES",
           "reset_launches"]

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"sparse_enc": 0}
#: the same launches by load route (:func:`enc_route`)
ENC_ROUTE_LAUNCHES: Dict[str, int] = {"vec16": 0, "scalar": 0}

_c = ctypes
_ENC_ARGS = ([_c.c_int] * 2 + [_c.c_void_p] * 5 + [_c.c_int] * 3
             + [_c.c_float, _c.c_void_p])


def reset_launches():
    for counts in (LAUNCHES, ENC_ROUTE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def enc_route(flat: torch.Tensor) -> str:
    """The kernel's load route for ``flat``: ``"vec16"`` (16-byte loads)
    when its data is 16-byte aligned, else ``"scalar"`` (one load per
    element, e.g. for a view that starts mid-buffer)."""
    return "vec16" if flat.data_ptr() % 16 == 0 else "scalar"


def sparse_enc(flat: torch.Tensor, *, kb: int, threshold: float = 0.0,
               frame_blocks: Optional[int] = None, totals: bool = False):
    """flat [nb*512] -> (values [nb*kb] in flat's dtype, indices int32
    [nb*kb], counts int32 [nb]), plus the uncapped counts of |x| >
    threshold int32 [nb] with ``totals``; ``kb`` in [1, 512].  Indices are
    local to frames of ``frame_blocks`` blocks (default: all nb, i.e.
    global)."""
    n = flat.shape[0] if flat.dim() == 1 else -1
    if n < 0 or n % SPARSE_B or not 1 <= kb <= SPARSE_B:
        raise ValueError(f"sparse_enc: flat [nb*{SPARSE_B}] and 1 <= kb <= "
                         f"{SPARSE_B} required, got {tuple(flat.shape)}, "
                         f"kb={kb}")
    nb = n // SPARSE_B
    fb = nb if frame_blocks is None else int(frame_blocks)
    if nb and (fb < 1 or nb % fb):
        raise ValueError(f"sparse_enc: frame_blocks={frame_blocks} must "
                         f"divide the {nb} blocks")
    how = route("sparse_enc", flat.device)
    count = cost.sparse_enc(n, kb, flat.dtype, totals)
    if how == "plain":
        return cost.run_plain("sparse_enc", count, sparse_enc_plain, flat,
                              kb, threshold, frame_blocks=fb, totals=totals)
    refuse_grad("sparse_enc", flat)
    code = dtype_code("sparse_enc", flat.dtype)
    if not flat.is_contiguous():
        raise ValueError("sparse_enc kernel: contiguous input required")
    if fb * SPARSE_B > 2 ** 31:
        raise ValueError("sparse_enc kernel: int32 indices need frames of "
                         "at most 2^31 elements")
    dev = flat.device
    vals = torch.empty(nb * kb, dtype=flat.dtype, device=dev)
    idxs = torch.empty(nb * kb, dtype=torch.int32, device=dev)
    cnts = torch.empty(nb, dtype=torch.int32, device=dev)
    tots = torch.empty(nb, dtype=torch.int32, device=dev) if totals else None
    cost.book("sparse_enc", count)
    if how == "meta":
        return (vals, idxs, cnts) if tots is None else \
            (vals, idxs, cnts, tots)
    load = enc_route(flat)
    fn = entry("sparse_enc", "repro_sparse_enc", _ENC_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(code, int(load == "vec16"), flat.data_ptr(), vals.data_ptr(),
                idxs.data_ptr(), cnts.data_ptr(),
                None if tots is None else tots.data_ptr(), nb, kb, max(fb, 1),
                float(threshold), stream)
    raise_on(rc, "sparse_enc")
    LAUNCHES["sparse_enc"] += 1
    ENC_ROUTE_LAUNCHES[load] += 1
    return (vals, idxs, cnts) if tots is None else (vals, idxs, cnts, tots)
