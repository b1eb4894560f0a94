"""Training (the port of ``repro.train``): so far the loss."""

from repro_torch.train import loss
from repro_torch.train.loss import lm_loss

__all__ = ["loss", "lm_loss"]
