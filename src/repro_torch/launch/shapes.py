"""Assigned input shapes x per-arch cell table (the port of
``repro.launch.shapes``).

``long_500k`` runs ``serve_step`` against a 512k-token cache and needs
sub-quadratic sequence mixing: it runs only for gemma3 (5/6 local layers +
length-sharded global cache), mamba2 (O(1) state) and recurrentgemma
(RG-LRU + 2048-window local attention). Pure full-attention archs skip it
(DESIGN.md Sec. 5). ``decode_*`` shapes run serve_step (one token against
a seq_len cache), not train_step.
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.configs import ARCH_IDS


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# archs with sub-quadratic sequence mixing -> run long_500k
LONG_CONTEXT_OK = {"gemma3_27b", "mamba2_370m", "recurrentgemma_2b"}


def cells_for(arch: str) -> List[str]:
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_OK:
        names.append("long_500k")
    return names


def all_cells() -> List[tuple]:
    return [(a, s) for a in ARCH_IDS for s in cells_for(a)]
