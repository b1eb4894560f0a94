"""Optimizer (the port of ``repro.optim``): AdamW, LR schedules and
gradient compression, in torch ops."""

from repro_torch.optim import adamw, compression, schedule
from repro_torch.optim.adamw import AdamWConfig

__all__ = ["adamw", "compression", "schedule", "AdamWConfig"]
