"""LR schedules (port of ``repro/optim/schedules.py``): pure functions
of the step, in float32."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Multiplicative LR scale in [min_ratio, 1]: linear warmup, then a
    cosine decay to ``min_ratio``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(warmup_steps, 1)
    progress = ((step - warmup_steps) / max(total_steps - warmup_steps, 1)
                ).clamp(0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (
        1 + torch.cos(math.pi * progress))
    return torch.where(step < warmup_steps, warm, cos)
