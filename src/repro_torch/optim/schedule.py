"""Learning-rate schedules of the port (``src/repro/optim/schedule.py``):
callables from a step tensor (the optimizer's int32 ``step``) to an f32
learning-rate tensor on the step's device, with the reference's f32
arithmetic in its order."""
from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def lr(step: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(step.float(), max=total_steps) / total_steps
        return base_lr * (min_frac + (1 - min_frac) * 0.5 *
                          (1 + torch.cos(math.pi * t)))
    return lr


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         min_frac: float = 0.05):
    cos = cosine_schedule(base_lr, max(1, total_steps - warmup), min_frac)

    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = base_lr * s / max(1, warmup)
        return torch.where(s < warmup, warm,
                           cos(torch.clamp(s - warmup, min=0)))
    return lr
