"""LR schedules.

Port of ``repro.optim.schedules``.  Each returns a 0-d float32 CPU tensor
for an integer (or tensor) step, computed in float32 as the reference's
jnp code computes it, so the optimizers multiply by the same float32
learning rate: bitwise, but for the cosine's ``cos``, which torch and XLA
each round their own way (an ulp apart now and then).
"""
from __future__ import annotations

import math

import torch


def _f32(step):
    return torch.as_tensor(step, dtype=torch.float32)


def warmup_cosine(step, *, peak, warmup, total, floor=0.0):
    step = _f32(step)
    warm = peak * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup, warm, cos)


def rsqrt(step, *, peak, warmup):
    step = _f32(step)
    # a float32 tensor over the step: torch takes "number / tensor" as a
    # reciprocal times the number, an ulp from the division jnp does; and
    # torch's float32 sqrt is not always correctly rounded, so it is taken
    # in float64 and rounded once (exact for a float32 argument), as XLA's
    ratio = torch.full_like(step, warmup) / step.clamp_min(1.0)
    root = torch.sqrt(ratio.double()).float()
    return peak * torch.minimum(step / max(warmup, 1), root)


def constant(step, *, peak, **_):
    return torch.full_like(_f32(step), peak)


SCHEDULES = {"cosine": warmup_cosine, "rsqrt": rsqrt, "constant": constant}
