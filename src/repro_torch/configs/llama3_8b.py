"""Llama-3-8B: 32L dense, GQA kv=8, 128k vocab. [arXiv:2407.21783;
unverified]"""
import dataclasses

from repro_torch.models.config import ModelConfig

_BASE = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    pattern=("attn",),
)


def config() -> ModelConfig:
    return _BASE


def reduced() -> ModelConfig:
    return dataclasses.replace(
        _BASE, name="llama3-8b-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512)
