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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: library name -> source file under csrc/
SOURCES: Dict[str, str] = {
    "flash_prefill": "flash_prefill.cu",
    "flash_decode": "flash_decode.cu",
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
