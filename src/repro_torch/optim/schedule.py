"""Learning-rate schedules (step -> lr, 0-d float32 tensors) — the port of
`repro.optim.schedule`, computed in float32 as the JAX package computes
them (the step cast to f32, Python constants rounded to f32 where they
meet it)."""

from __future__ import annotations

import math

import torch


def linear_warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                         floor: float = 0.1) -> torch.Tensor:
    """Linear warm-up to peak_lr over `warmup` steps, then a cosine decay
    to floor * peak_lr at `total`."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def constant(step, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full((), peak_lr, dtype=torch.float32,
                      device=torch.as_tensor(step).device)


SCHEDULES = {"cosine": linear_warmup_cosine, "constant": constant}
