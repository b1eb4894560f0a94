"""Model zoo (the port of ``repro.models``): one block-pattern LM covering
dense / MoE / SSM / hybrid / VLM-backbone / audio-backbone families, with
the score, prefill and decode modes and their caches."""

from repro_torch.models import (blocks, config, layers, model, moe, rglru,
                                sharding, ssd)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (cache_spec, forward, init_cache,
                                      init_params, make_positions,
                                      param_spec)

__all__ = [
    "blocks", "config", "layers", "model", "moe", "rglru", "sharding", "ssd",
    "ModelConfig", "cache_spec", "forward", "init_cache", "init_params",
    "make_positions", "param_spec",
]
