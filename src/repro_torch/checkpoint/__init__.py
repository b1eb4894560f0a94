"""Checkpointing (the port of ``repro.checkpoint``)."""

from repro_torch.checkpoint.manager import (AsyncCheckpointer, gc,
                                            latest_step, restore, save, steps)

__all__ = ["AsyncCheckpointer", "gc", "latest_step", "restore", "save",
           "steps"]
