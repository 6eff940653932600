"""Learning-rate schedules, as ``repro.optim.schedule``. The paper finds
Madam robust at a fixed η=2⁻⁷; warmup and cosine are for the SGD/AdamW
baselines. Each schedule maps a step (an int or a tensor) to a 0-d f32
tensor on the step's device (the CPU for an int)."""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "warmup_cosine", "warmup_stable_decay"]


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    def fn(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak_lr - floor) * (1.0 + torch.cos(
            math.pi * frac))
        return torch.where(step < warmup_steps, warm, cos)
    return fn


def warmup_stable_decay(peak_lr: float, warmup_steps: int, stable_steps: int,
                        decay_steps: int, floor_frac: float = 0.1):
    def fn(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        decay_frac = torch.clamp((step - warmup_steps - stable_steps)
                                 / max(decay_steps, 1), 0.0, 1.0)
        dec = peak_lr * (1.0 - (1.0 - floor_frac) * decay_frac)
        peak = torch.full_like(step, peak_lr)
        return torch.where(step < warmup_steps, warm, torch.where(
            step < warmup_steps + stable_steps, peak, dec))
    return fn
