"""RecurrentGemma-2B: 26L Griffin hybrid -- repeating (RG-LRU, RG-LRU,
local-attention) pattern (2:1), 2048-token window, MQA (kv=1), lru_width
2560. [arXiv:2402.19427; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

_BASE = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    pattern=("rglru", "rglru", "local"),
    window=2048,
    lru_width=2560,
    conv_width=4,
    rope_theta=10_000.0,
    emb_scale_by_sqrt_dim=True,
    tie_embeddings=True,
    mlp_act="gelu",
)


def config() -> ModelConfig:
    return _BASE


def reduced() -> ModelConfig:
    return dataclasses.replace(
        _BASE, name="recurrentgemma-reduced", n_layers=5, d_model=64,
        n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128, vocab_size=512,
        window=16, lru_width=64)
