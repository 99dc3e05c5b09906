"""Build-at-first-use for the port's CUDA kernels (nvcc -> .so -> ctypes).

Each source under ``csrc/`` compiles with ``nvcc`` into its own shared
library with a plain C interface, for ``sm_90a``.  Libraries land in
``build/kernels/`` at the repository root (listed in ``.gitignore``), named
by a hash of the sources, headers and flags, so an edited kernel rebuilds
and an unchanged one loads at once.  :func:`build_all` starts one ``nvcc``
per source together and waits for all of them.

Nothing here runs at import time: the CPU tests import every module of the
port on machines without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: library name -> source file under csrc/
SOURCES: Dict[str, str] = {
    "flash_prefill": "flash_prefill.cu",
    "flash_prefill_sm90": "flash_prefill_sm90.cu",
    "flash_decode": "flash_decode.cu",
    "flash_decode_gqa": "flash_decode_gqa.cu",
    "quant8": "quant8.cu",
    "sparse_enc": "sparse_enc.cu",
    "sparse_dec": "sparse_dec.cu",
    "rglru_scan": "rglru_scan.cu",
    "ssd_scan": "ssd_scan.cu",
    "ssd_decode": "ssd_decode.cu",
    "norm": "norm.cu",
    "rotary": "rotary.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
#: per library: build seconds (0.0 when loaded from an earlier build) and
#: the compiler's register/shared-memory report
BUILD_LOG: Dict[str, Dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels build "
                           "only on a machine with the CUDA toolkit")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{_digest(name)}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / SOURCES[name])]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all(names=None) -> Dict[str, Dict]:
    """Compile every listed library that is not built yet, all ``nvcc``
    processes at once; raises with the compiler output if any fails."""
    names = list(names or SOURCES)
    t0 = time.perf_counter()
    procs = {n: _start(n) for n in names}
    errors = []
    for n, proc in procs.items():
        out = library_path(n)
        if proc is None:
            BUILD_LOG.setdefault(n, {"seconds": 0.0, "ptxas": ""})
            continue
        log, _ = proc.communicate()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        if proc.returncode != 0:
            errors.append(f"{n}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_LOG[n] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return {n: BUILD_LOG[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (building it first if needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


# ---------------------------------------------------------------------------
# what every kernel wrapper shares
# ---------------------------------------------------------------------------

#: dtype codes of the C entry points (``kFloat32``/``kBFloat16`` in
#: ``csrc/common.cuh``), keyed by torch dtype name
DTYPE_CODE = {"float32": 0, "bfloat16": 1}


def dtype_code(name: str, dtype) -> int:
    """The C code of ``dtype``; raises for a dtype the kernels do not
    take."""
    tag = str(dtype).rpartition(".")[2]
    if tag not in DTYPE_CODE:
        raise TypeError(f"{name} kernel: float32 or bfloat16, got {dtype}")
    return DTYPE_CODE[tag]


def entry(name: str, fn: str, argtypes):
    """C entry point ``fn`` of library ``name``, its argument types set
    (``c_void_p`` for pointers and the stream) and returning an int."""
    f = getattr(load(name), fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return f


def route(name: str, device) -> str:
    """``"plain"`` for a CPU tensor, ``"kernel"`` for a CUDA tensor,
    ``"meta"`` for a meta tensor (shapes only: the wrapper returns empty
    outputs of the kernel's shapes and dtypes and books its count, see
    ``cost.py``); there is no other route and no fallback between them."""
    if device.type == "cpu":
        return "plain"
    if device.type == "cuda":
        return "kernel"
    if device.type == "meta":
        return "meta"
    raise ValueError(f"{name}: no kernel or plain version for {device}")


def needs_grad(*tensors) -> bool:
    """Grad mode is on and an input requires grad (``None`` entries are
    ignored): autograd would have to pass a gradient through the call."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors):
    """Raise when autograd would have to pass a gradient through a kernel
    that has no backward (:func:`needs_grad`).  Without this the kernel's
    output (written through ctypes) would come back with no ``grad_fn`` and
    ``backward()`` would skip it silently."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward, so it cannot run on "
            f"inputs that require grad (wrap the call in torch.no_grad() "
            f"or detach the inputs)")


def raise_on(rc: int, name: str):
    """Raise if a C entry point returned a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
