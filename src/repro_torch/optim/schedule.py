"""LR schedules (the port of ``repro.optim.schedule``): pure functions of
the step, computed in float32 tensors as the JAX package computes them."""
from __future__ import annotations

import math

import torch

from repro_torch.core.backend import resolve_device


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _device(step, device) -> torch.device:
    """``step``'s device for a tensor step, else ``resolve_device(device)``
    (CUDA unless the caller asks for the CPU)."""
    if isinstance(step, torch.Tensor) and device is None:
        return step.device
    return resolve_device(device)


def warmup_cosine(step, peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1, device=None) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine decay to ``min_ratio *
    peak_lr`` at ``total_steps``: a float32 scalar on ``step``'s device
    when it is a tensor, else on ``device`` (CUDA by default)."""
    device = _device(step, device)
    s = _f32(step, device)
    warm = peak_lr * s / _f32(max(warmup_steps, 1), device)
    prog = torch.clamp((s - warmup_steps)
                       / _f32(max(total_steps - warmup_steps, 1), device),
                       0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1.0 + torch.cos(_f32(math.pi, device) * prog)))
    return torch.where(s < warmup_steps, warm, cos)


def constant(step, lr: float, device=None) -> torch.Tensor:
    return torch.full((), lr, dtype=torch.float32,
                      device=_device(step, device))
