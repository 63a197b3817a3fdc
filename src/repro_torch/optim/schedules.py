"""Learning-rate schedules, pure functions of the step counter (port of
``src/repro/optim/schedules.py``).  ``step`` is an int or a tensor; the
rate is an f32 tensor on ``step``'s device (the CPU for an int)."""
from __future__ import annotations

import math

import torch


def _steps(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, peak=3e-4, warmup=100, total=10000, floor=0.1):
    s = _steps(step)
    warm = peak * s / max(warmup, 1)
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor * peak + (1 - floor) * peak * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(s < warmup, warm, cos)


def constant_lr(step, *, peak=3e-4, **_):
    return torch.full_like(_steps(step), peak, dtype=torch.float32)
