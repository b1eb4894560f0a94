"""Qwen2-72B: 80L dense, GQA kv=8, QKV bias. [arXiv:2407.10671; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

_BASE = ModelConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    pattern=("attn",),
)


def config() -> ModelConfig:
    return _BASE


def reduced() -> ModelConfig:
    return dataclasses.replace(
        _BASE, name="qwen2-72b-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512)
