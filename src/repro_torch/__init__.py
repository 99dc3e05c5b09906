"""PyTorch/CUDA port of the stream-pipeline system (``src/repro`` is the
JAX reference it is held against).

The port runs on an NVIDIA GPU: every entry point defaults to ``cuda`` and
raises when CUDA is absent, unless the caller passes ``device="cpu"``
explicitly (the CPU parity tests do).  The attention kernels are written by
hand in CUDA C++ under ``kernels/csrc`` and built at first use.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
