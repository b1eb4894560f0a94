"""Granite-34B-Code: 88L dense llama-arch with MQA (kv=1).
[arXiv:2405.04324; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

_BASE = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=10_000.0,
    tie_embeddings=True,
    mlp_act="gelu",
    mlp_gated=False,          # GPT-BigCode-style 2-matrix FFN
    pattern=("attn",),
)


def config() -> ModelConfig:
    return _BASE


def reduced() -> ModelConfig:
    return dataclasses.replace(
        _BASE, name="granite-34b-reduced", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=1, head_dim=16, d_ff=128, vocab_size=512)
