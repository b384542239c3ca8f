"""LR schedules (warmup + cosine / constant).

Port of ``repro/optim/schedules.py``: the same formulas in the same
order of operations.  A schedule takes an int or a 0-d tensor step and
returns a float32 0-d tensor (on the step's device)."""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=_step(step).device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        s = _step(step)
        warm = peak_lr * s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup_steps, warm, cos)
    return fn
