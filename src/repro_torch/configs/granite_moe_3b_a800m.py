"""Granite-3.0-3B-A800M MoE: 32L, 40 experts top-8, fine-grained d_ff=512,
GQA kv=8. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

_BASE = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    n_experts=40,
    top_k=8,
    rope_theta=10_000.0,
    tie_embeddings=True,
    pattern=("attn",),
)


def config() -> ModelConfig:
    return _BASE


def reduced() -> ModelConfig:
    return dataclasses.replace(
        _BASE, name="granite-moe-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=32, vocab_size=515, n_experts=8,
        top_k=2)
