"""Training (the port of ``repro.train``): the loss, the train step and
GPipe-style pipeline parallelism."""

from repro_torch.train import loss, pipeline, train_step
from repro_torch.train.loss import lm_loss
from repro_torch.train.train_step import (TrainConfig, init_state,
                                          make_train_step)

__all__ = ["loss", "pipeline", "train_step", "lm_loss", "TrainConfig",
           "init_state", "make_train_step"]
