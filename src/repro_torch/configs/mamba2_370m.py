"""Mamba2-370M: 48L attention-free SSD (state-space duality), state N=128,
headdim 64, expand 2 (d_inner 2048 -> 32 heads). [arXiv:2405.21060;
unverified]"""
import dataclasses

from repro_torch.models.config import ModelConfig

_BASE = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    d_ff=0,
    vocab_size=50280,
    pattern=("ssd",),
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_chunk=256,
    conv_width=4,
    tie_embeddings=True,
)


def config() -> ModelConfig:
    return _BASE


def reduced() -> ModelConfig:
    return dataclasses.replace(
        _BASE, name="mamba2-reduced", n_layers=3, d_model=64, vocab_size=512,
        ssm_state=16, ssm_headdim=16, ssm_chunk=16)
