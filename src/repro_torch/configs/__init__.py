"""Assigned architecture configs (public literature) + paper experiment
configs. ``get(name)`` -> full ModelConfig; ``get_reduced(name)`` -> smoke
variant of the same family. The port's own copies of ``repro.configs``:
the same field values, each file naming its source."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

__all__ = ["ARCH_IDS", "get", "get_reduced", "all_configs"]

ARCH_IDS: List[str] = [
    "dbrx_132b",
    "granite_moe_3b_a800m",
    "gemma3_27b",
    "qwen2_72b",
    "granite_34b",
    "llama3_8b",
    "qwen2_vl_2b",
    "mamba2_370m",
    "musicgen_large",
    "recurrentgemma_2b",
]


def _mod(name: str):
    return importlib.import_module(f"repro_torch.configs.{name.replace('-', '_')}")


def get(name: str) -> ModelConfig:
    return _mod(name).config().validate()


def get_reduced(name: str) -> ModelConfig:
    return _mod(name).reduced().validate()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get(a) for a in ARCH_IDS}
