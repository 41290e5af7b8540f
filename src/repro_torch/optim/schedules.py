"""LR schedules as pure functions of the step counter.

The port of the reference's ``optim/schedules.py``: the same float32
arithmetic (the step an int32, Python constants taken in float32), on
0-d float32 tensors on the CPU.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.int32).to(torch.float32)


def linear_warmup(step, warmup_steps: int, peak_lr: float) -> torch.Tensor:
    x = (_f32(step) + 1) / float(max(1, warmup_steps))
    return peak_lr * torch.clamp(x, max=1.0)


def cosine_schedule(step, warmup_steps: int, total_steps: int,
                    peak_lr: float, min_lr: float = 0.0) -> torch.Tensor:
    warm = linear_warmup(step, warmup_steps, peak_lr)
    frac = torch.clamp((_f32(step) - warmup_steps)
                       / float(max(1, total_steps - warmup_steps)), 0.0, 1.0)
    cos = min_lr + 0.5 * (peak_lr - min_lr) * (1 + torch.cos(math.pi * frac))
    return torch.where(torch.as_tensor(step) < warmup_steps, warm, cos)
