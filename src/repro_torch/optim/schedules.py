"""Learning-rate schedules — port of ``repro/optim/schedules.py``.

Pure functions of the step counter (an int tensor), computed in f32 as
the JAX functions compute them."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def constant(step, **_) -> torch.Tensor:
    return torch.ones_like(torch.as_tensor(step), dtype=torch.float32)


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000,
                  min_frac: float = 0.1) -> torch.Tensor:
    """Scale factor in [min_frac, 1]: linear warmup then cosine decay."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    progress = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1.0 - min_frac) * 0.5 * (1.0 + torch.cos(math.pi * progress))
    return warm * torch.where(step < warmup, torch.ones_like(cos), cos)
