"""Device meshes of the port (``src/repro/launch/mesh.py``).

A :class:`Mesh` names its axes and holds one torch device per *slot*, in a
numpy object array of the mesh's shape.  Slots may share a physical device:
eight ``cpu`` slots are the tests' counterpart of the JAX package's eight
forged host devices, and several ``cuda:0`` slots run a mesh's split, each
slot's program and the gather on one card.  A mesh of distinct GPUs puts
each slot's work on its own card.

Single pod = 16 x 16 devices, axes (data, model); multi-pod = 2 x 16 x 16,
axes (pod, data, model): the ``pod`` axis is the among-device axis, the
paper's device boundary.

The H100 constants (``H100_*``) take the place of the JAX package's
``V5E_*``: the roofline of the analysis tools (``launch/hlo_analysis.py``)
and the bounds of ``kernels/cost.py`` divide by them.

:class:`P` is the port's partition spec: one entry per tensor dimension,
``None`` (not split), an axis name, or a tuple of axis names (split over
their product, the first axis outermost).  ``launch/spmd.py`` splits and
gathers tensors by such specs.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "P", "make_host_mesh", "make_production_mesh",
           "mesh_axis_sizes", "data_axes", "data_axis_size", "batch_spec",
           "set_mesh", "current_mesh", "mesh_fingerprint", "H100_NAME",
           "H100_BF16_FLOPS", "H100_F32_FLOPS", "H100_HBM_BW",
           "H100_HBM_BYTES", "H100_NVLINK_BW", "H100_SMS"]

#: the card the constants below describe (``torch.cuda.get_device_name``)
H100_NAME = "NVIDIA H100 80GB HBM3"
#: dense bf16 FLOP/s on the tensor cores (NVIDIA H100 SXM5 data sheet:
#: 989.4 TFLOPS without sparsity)
H100_BF16_FLOPS = 989e12
#: float32 FLOP/s outside the tensor cores (the data sheet's 67 TFLOPS FP32)
H100_F32_FLOPS = 67e12
#: HBM3 bytes/s (the data sheet's 3.35 TB/s)
H100_HBM_BW = 3.35e12
#: HBM3 bytes on the card (80 GB)
H100_HBM_BYTES = 80e9
#: streaming multiprocessors of the SXM5 card
H100_SMS = 132
#: NVLink 4 bytes/s a direction per card: 18 links of 25 GB/s (the data
#: sheet's 900 GB/s bidirectional); takes the place of ``V5E_ICI_BW``
H100_NVLINK_BW = 450e9


class P(tuple):
    """Partition spec: ``P("data", None)`` splits dim 0 over ``data`` and
    keeps dim 1 whole; ``P()`` replicates."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Axis names over a numpy object array of torch devices (one entry a
    slot).  ``shape`` maps each axis to its size, as a JAX mesh's does."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a mesh of shape {arr.shape} needs "
                             f"{arr.ndim} axis names, got {axis_names}")
        out = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            out[idx] = _device(arr[idx])
        self.devices = out
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The physical devices under the slots, in slot order."""
        seen = []
        for d in self.devices.flat:
            if d not in seen:
                seen.append(d)
        return tuple(seen)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.distinct_devices()]})")


_state = threading.local()


@contextmanager
def set_mesh(mesh):
    """Ambient-mesh context (``current_mesh()`` reads it), as the JAX
    package's ``set_mesh`` makes a mesh ambient."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def current_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


def _visible_cuda() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The 16 x 16 (data, model) pod mesh, or 2 x 16 x 16 (pod, data,
    model) with ``multi_pod``, over the visible CUDA devices; raises when
    fewer are visible, as ``jax.make_mesh`` does.  ``devices``: one device
    a slot instead (a single device, e.g. ``"meta"``, fills every slot: the
    dry run's counterpart of the JAX package's forged host devices)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    if devices is not None:
        devs = [devices] * need if isinstance(devices, (str, torch.device)) \
            else list(devices)
        if len(devs) != need:
            raise ValueError(f"the production mesh {shape} needs {need} "
                             f"slots; {len(devs)} given")
    else:
        have = _visible_cuda()
        if have < need:
            raise ValueError(f"the production mesh {shape} needs {need} "
                             f"CUDA devices; {have} visible")
        devs = [torch.device("cuda", i) for i in range(need)]
    arr = np.empty(need, dtype=object)
    for i, d in enumerate(devs):
        arr[i] = d
    return Mesh(arr.reshape(shape), axes)


def make_host_mesh(model_parallel: int = 1, devices=None) -> Mesh:
    """A (data, model) mesh over ``devices``, one slot each (default: every
    visible CUDA device; a repeated device gives several slots on it).
    ``model_parallel`` slots go to the model axis, the rest to data."""
    if devices is None:
        n = _visible_cuda()
        if n == 0:
            raise RuntimeError(
                "no CUDA device is visible; pass devices=[...] (e.g. "
                "['cpu'] * 8) to build a mesh of CPU slots")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = [_device(d) for d in devices]
    n = len(devs)
    mp = max(1, min(int(model_parallel), n))
    if n % mp:
        raise ValueError(f"{n} slots do not split into a model axis of {mp}")
    arr = np.empty((n // mp, mp), dtype=object)
    for i, d in enumerate(devs):
        arr[i // mp, i % mp] = d
    return Mesh(arr, ("data", "model"))


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes carrying the batch dimension (pod + data when multi-pod)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def data_axis_size(mesh) -> int:
    """Slots along the batch-carrying axes, multiplied."""
    sizes = mesh_axis_sizes(mesh)
    n = 1
    for a in data_axes(mesh):
        n *= sizes[a]
    return n


def batch_spec(mesh):
    """Spec entry for a leading batch/frame axis laid out along the mesh's
    data axes (None when the mesh has none)."""
    dp = data_axes(mesh)
    if not dp:
        return None
    return dp if len(dp) > 1 else dp[0]


def mesh_fingerprint(mesh) -> Optional[Tuple]:
    """Hashable identity of a mesh for executable-cache keys: axis names,
    shape, and each slot's device type and index in slot order.  Two equal
    meshes share executables; 4 x ``cuda:0`` never matches 8 x
    ``cuda:0``."""
    if mesh is None:
        return None
    if not (hasattr(mesh, "axis_names") and hasattr(mesh, "devices")):
        raise TypeError(f"expected a Mesh, got {type(mesh).__name__} "
                        f"{mesh!r}")
    return (tuple(mesh.axis_names), tuple(mesh.devices.shape),
            tuple((d.type, d.index) for d in mesh.devices.flat))
