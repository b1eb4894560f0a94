"""Gemma-3-27B: 62L dense, 5:1 local:global attention (1024-token sliding
window), GQA kv=16, QK-norm, sandwich norms, 262k vocab, 128k context.
[hf:google/gemma-3-1b-pt (family); unverified]"""
import dataclasses

from repro_torch.models.config import ModelConfig

_BASE = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    pattern=("local",) * 5 + ("attn",),
    window=1024,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    qk_norm=True,
    post_norms=True,
    emb_scale_by_sqrt_dim=True,
    tie_embeddings=True,
    mlp_act="gelu",
)


def config() -> ModelConfig:
    return _BASE


def reduced() -> ModelConfig:
    return dataclasses.replace(
        _BASE, name="gemma3-reduced", n_layers=8, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512, window=16)
