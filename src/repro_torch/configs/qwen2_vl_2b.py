"""Qwen2-VL-2B backbone: 28L, GQA kv=2, M-RoPE (t/h/w sections 16/24/24 of
the 64 rotary frequency slots). The vision frontend is a STUB per the brief:
``input_specs()`` supplies token ids plus 3-axis M-RoPE position ids (for
text-only smoke runs all three axes carry identical ids).
[arXiv:2409.12191; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

_BASE = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    tie_embeddings=True,
    pattern=("attn",),
)


def config() -> ModelConfig:
    return _BASE


def reduced() -> ModelConfig:
    return dataclasses.replace(
        _BASE, name="qwen2-vl-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        mrope_sections=(2, 3, 3))
