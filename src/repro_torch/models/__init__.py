"""Model configuration for the roofline's analytic terms: the port's copy
of ``repro.models.config``. The model stack itself (blocks, layers, MoE,
SSD, RG-LRU, sharding, the forward pass) is still to be ported (ROADMAP
A8)."""

from repro_torch.models import config
from repro_torch.models.config import ModelConfig

__all__ = ["config", "ModelConfig"]
