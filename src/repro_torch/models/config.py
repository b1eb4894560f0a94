"""Unified model configuration covering all assigned architecture families
(the port's own copy of ``repro.models.config``; it imports nothing of the
JAX package). The roofline's analytic terms (``repro_torch.roofline.report``)
read it.

A model is a stack of ``n_layers`` blocks whose sequence-mixer kind follows a
repeating ``pattern`` (period p):

    dense transformers      pattern = ("attn",)
    gemma3 local:global 5:1 pattern = ("local",)*5 + ("attn",)
    recurrentgemma 2:1      pattern = ("rglru", "rglru", "local")
    mamba2                  pattern = ("ssd",)

``n_layers`` need not be a multiple of p: the stack is scan(n_layers // p
periods) + the remaining ``n_layers % p`` blocks applied explicitly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _group_runs(kinds) -> Tuple[Tuple[str, int], ...]:
    runs = []
    for k in kinds:
        if runs and runs[-1][0] == k:
            runs[-1][1] += 1
        else:
            runs.append([k, 1])
    return tuple((k, n) for k, n in runs)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    vocab_size: int
    # -- attention ----------------------------------------------------------
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False
    window: int = 0                  # local-attention window (tokens)
    rope_theta: float = 10_000.0
    rope_theta_local: float = 10_000.0
    mrope_sections: Optional[Tuple[int, ...]] = None   # qwen2-vl M-RoPE
    attn_logit_softcap: float = 0.0
    post_norms: bool = False         # gemma-style sandwich norms
    # -- mlp ------------------------------------------------------------------
    d_ff: int = 0
    mlp_act: str = "silu"            # silu (swiglu) | gelu (geglu)
    mlp_gated: bool = True           # False = classic 2-matrix FFN
    # -- block pattern --------------------------------------------------------
    pattern: Tuple[str, ...] = ("attn",)
    # -- MoE ------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # -- SSM (mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_chunk: int = 256
    conv_width: int = 4
    # -- RG-LRU (recurrentgemma) ----------------------------------------------
    lru_width: int = 0
    # -- embedding / output ----------------------------------------------------
    tie_embeddings: bool = False
    emb_scale_by_sqrt_dim: bool = False   # gemma-style
    final_logit_softcap: float = 0.0
    # -- numerics ---------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    kv_cache_dtype: str = "bfloat16"   # "int8": quantized serving cache
    rms_eps: float = 1e-6

    # ------------------------------------------------------------------
    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_full_periods(self) -> int:
        return self.n_layers // self.period

    @property
    def remainder_kinds(self) -> Tuple[str, ...]:
        return self.pattern[: self.n_layers % self.period]

    def runs(self) -> Tuple[Tuple[str, int], ...]:
        """The pattern grouped into maximal runs of one kind, e.g. gemma3's
        ("local",)*5+("attn",) -> (("local", 5), ("attn", 1)). Each run is
        executed as an inner scan so only ONE layer's gradients are live at
        a time (memory; see model.py)."""
        return _group_runs(self.pattern)

    def remainder_runs(self) -> Tuple[Tuple[str, int], ...]:
        return _group_runs(self.remainder_kinds)

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up so the embedding table shards evenly over a
        16-way tensor axis (Megatron-style padding; padded ids are never
        emitted by the pipeline and are masked out of the loss)."""
        return _round_up(self.vocab_size, 256)

    @property
    def ssm_dinner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_dinner // self.ssm_headdim

    def validate(self) -> "ModelConfig":
        for kind in self.pattern:
            assert kind in ("attn", "local", "ssd", "rglru"), kind
        if any(k in ("attn", "local") for k in self.pattern):
            assert self.n_heads > 0 and self.n_kv_heads > 0
            assert self.head_dim > 0
            assert self.n_heads % self.n_kv_heads == 0
        if "local" in self.pattern:
            assert self.window > 0
        if "ssd" in self.pattern:
            assert self.ssm_state > 0
            assert self.ssm_dinner % self.ssm_headdim == 0
        if "rglru" in self.pattern:
            assert self.lru_width > 0
        if self.n_experts:
            assert 0 < self.top_k <= self.n_experts
        return self

    # -- analytics used by the roofline (6*N*D rule) --------------------
    def param_count(self) -> int:
        """Exact parameter count (embedding included once, untied head extra)."""
        return _count_params(self, active_only=False)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        return _count_params(self, active_only=True)


def _count_params(cfg: ModelConfig, active_only: bool) -> int:
    d = cfg.d_model
    n_mats = 3 if cfg.mlp_gated else 2
    total = cfg.vocab_padded * d                      # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_padded * d                 # lm head
    kinds = list(cfg.pattern) * cfg.n_full_periods + list(cfg.remainder_kinds)
    for kind in kinds:
        has_mlp = (kind in ("attn", "local") and (cfg.d_ff or cfg.n_experts)
                   ) or (kind == "rglru" and cfg.d_ff)
        total += d + (d if has_mlp else 0)            # pre norms
        if cfg.post_norms:
            total += d + (d if has_mlp else 0)        # sandwich norms
        if kind in ("attn", "local"):
            qd = cfg.n_heads * cfg.head_dim
            kvd = cfg.n_kv_heads * cfg.head_dim
            total += d * qd + 2 * d * kvd + qd * d
            if cfg.qkv_bias:
                total += qd + 2 * kvd
            if cfg.qk_norm:
                total += 2 * cfg.head_dim
        elif kind == "ssd":
            din, h, g, n = (cfg.ssm_dinner, cfg.ssm_nheads, cfg.ssm_ngroups,
                            cfg.ssm_state)
            conv_dim = din + 2 * g * n
            total += d * (2 * din + 2 * g * n + h)    # in_proj
            total += (cfg.conv_width + 1) * conv_dim  # conv w + b
            total += 3 * h                            # A_log, D, dt_bias
            total += din                              # gated norm
            total += din * d                          # out_proj
        elif kind == "rglru":
            w = cfg.lru_width
            total += 3 * d * w                        # w_gate, w_x, w_out
            total += (cfg.conv_width + 1) * w         # conv w + b
            total += 2 * w * w + w                    # gates W_a, W_i, Lambda
        # MLP (attention and rglru blocks carry one)
        if kind in ("attn", "local") and cfg.n_experts:
            e = cfg.top_k if active_only else cfg.n_experts
            total += e * 3 * d * cfg.d_ff + d * cfg.n_experts  # experts+router
        elif has_mlp:
            total += n_mats * d * cfg.d_ff
    total += d                                        # final norm
    return int(total)
