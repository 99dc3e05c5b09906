"""Device selection: the GPU unless the caller asks for the CPU.

There is no silent fallback.  ``resolve_device(None)`` means ``cuda`` and
raises when CUDA is unavailable; the CPU is used only when a caller passes
``device="cpu"`` (or a CPU ``torch.device``) explicitly.  ``device="meta"``
builds trees of shapes and dtypes only, allocating nothing (the launch
shape helpers of ``launch/steps.py``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU "
            "explicitly (the port never falls back on its own)")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    """Seeded generator living on ``device`` (CUDA generators draw on the
    card, so full-width weights are made where they are used)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
