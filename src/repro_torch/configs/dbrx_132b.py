"""DBRX-132B: 40L fine-grained MoE, 16 experts top-4, GQA kv=8.
[hf:databricks/dbrx-base; unverified]"""
import dataclasses

from repro_torch.models.config import ModelConfig

_BASE = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    top_k=4,
    rope_theta=500_000.0,
    pattern=("attn",),
)


def config() -> ModelConfig:
    return _BASE


def reduced() -> ModelConfig:
    return dataclasses.replace(
        _BASE, name="dbrx-132b-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=96, vocab_size=512, n_experts=4,
        top_k=2)
