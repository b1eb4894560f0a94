"""MusicGen-large backbone: 48L decoder-only over EnCodec audio tokens
(2048-entry codebook), MHA (kv=32). The EnCodec tokenizer/delay-pattern
frontend is a STUB per the brief: ``input_specs()`` supplies precomputed
frame token ids. Positions use RoPE (TPU-native adaptation of the original
sinusoidal embeddings; noted in DESIGN.md). [arXiv:2306.05284; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

_BASE = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    mlp_act="gelu",
    mlp_gated=False,          # classic transformer FFN
    rope_theta=10_000.0,
    pattern=("attn",),
)


def config() -> ModelConfig:
    return _BASE


def reduced() -> ModelConfig:
    return dataclasses.replace(
        _BASE, name="musicgen-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256)
