"""Mamba-2 SSD (state-space duality) mixer, chunked (the port of
``repro.models.ssd``).

The chunked formulation (Dao & Gu 2024, Sec. 6) splits the sequence into
chunks: intra-chunk interactions are a masked (chunk x chunk) matmul, and
inter-chunk interactions flow through a small (H, P, N) state carried from
chunk to chunk. Decode keeps (conv_state, ssm_state) and costs O(1) per
token. A cache passed to :func:`ssd_apply` is written in place and
returned.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (_dtype, _pdtype, dense_apply,
                                       dense_init, normal, rmsnorm_apply)

Params = Dict[str, Any]


def _conv_dim(cfg: ModelConfig) -> int:
    return cfg.ssm_dinner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def ssd_init(key: torch.Generator, cfg: ModelConfig) -> Params:
    d, din, h = cfg.d_model, cfg.ssm_dinner, cfg.ssm_nheads
    gn = cfg.ssm_ngroups * cfg.ssm_state
    pdt, dev = _pdtype(cfg), key.device
    return {
        "in_proj": dense_init(key, d, 2 * din + 2 * gn + h, cfg),
        "conv_w": normal(key, (cfg.conv_width, _conv_dim(cfg)), pdt)
        / math.sqrt(cfg.conv_width),
        "conv_b": torch.zeros((_conv_dim(cfg),), dtype=pdt, device=dev),
        "A_log": torch.log(torch.arange(1, h + 1, dtype=pdt, device=dev)),
        "D": torch.ones((h,), dtype=pdt, device=dev),
        "dt_bias": torch.zeros((h,), dtype=pdt, device=dev),
        "norm_scale": torch.ones((din,), dtype=pdt, device=dev),
        "out_proj": dense_init(key, din, d, cfg),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv via shifted adds: x (B, L, C), w (W, C)."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    y = torch.zeros_like(x)
    for i in range(W):
        y = y + xp[:, i:i + x.shape[1]] * w[i].to(x.dtype)
    return y + b.to(x.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., c) -> (..., c, c): out[i, j] = sum_{j < k <= i} x[k], -inf
    above the diagonal."""
    c = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, -math.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int,
                initial_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x (b, l, h, p); dt (b, l, h) (post-softplus); A (h,) negative;
    B, C (b, l, h, n) (already expanded from groups to heads).
    Returns (y (b, l, h, p), final_state (b, h, p, n)). All f32.
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = l // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, h, n)
    Cc = C.reshape(b, nc, chunk, h, n)

    x_dt = xc * dtc[..., None]
    dA = dtc * A                                     # (b, nc, c, h)
    dA_h = dA.permute(0, 1, 3, 2)                    # (b, nc, h, c)
    dA_cs = torch.cumsum(dA_h, dim=-1)               # (b, nc, h, c)

    # intra-chunk (diagonal blocks)
    Lm = torch.exp(_segsum(dA_h))                    # (b, nc, h, c, c)
    CB = torch.einsum("bzchn,bzshn->bzhcs", Cc, Bc)
    y_diag = torch.einsum("bzhcs,bzshp->bzchp", CB * Lm, x_dt)

    # chunk summaries -> inter-chunk recurrence
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)  # (b, nc, h, c)
    states = torch.einsum("bzchn,bzhc,bzchp->bzhpn", Bc, decay_states, x_dt)
    chunk_decay = torch.exp(dA_cs[..., -1])          # (b, nc, h)

    state = (x.new_zeros((b, h, p, n)) if initial_state is None
             else initial_state)
    prev = []                                        # state entering chunk
    for z in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, z, :, None, None] + states[:, z]
    prev = torch.stack(prev, dim=1)                  # (b, nc, h, p, n)

    decay_out = torch.exp(dA_cs)                     # (b, nc, h, c)
    y_off = torch.einsum("bzchn,bzhpn,bzhc->bzchp", Cc, prev, decay_out)

    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, state


def _split_in_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    din, h = cfg.ssm_dinner, cfg.ssm_nheads
    gn = cfg.ssm_ngroups * cfg.ssm_state
    return torch.split(zxbcdt, [din, din + 2 * gn, h], dim=-1)


def _expand_groups(v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(..., G*N) -> (..., H, N): heads within a group share B/C."""
    g, n, h = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    v = v.reshape(v.shape[:-1] + (g, n))
    return torch.repeat_interleave(v, h // g, dim=-2)


def ssd_apply(p: Params, u: torch.Tensor, cfg: ModelConfig,
              cache: Optional[Params] = None
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Full SSD block: in_proj -> causal conv -> SSD -> gated norm ->
    out_proj. u (B, L, d). With a cache and L == 1, runs the O(1) decode
    step; with a cache and L > 1, runs the chunked prefill and writes the
    final (conv, ssm) states into the cache."""
    B_, L, _ = u.shape
    h, pdim, n = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    din = cfg.ssm_dinner
    splits = [din, cfg.ssm_ngroups * n, cfg.ssm_ngroups * n]
    zxbcdt = dense_apply(p["in_proj"], u)
    z, xBC, dt_raw = _split_in_proj(cfg, zxbcdt)
    A = -torch.exp(p["A_log"].float())
    D = p["D"].float()[None, None, :, None]

    if cache is not None and L == 1:
        window = torch.cat([cache["conv"], xBC.to(cache["conv"].dtype)],
                           dim=1)                                # (B, W, C)
        conv_out = (torch.einsum("bwc,wc->bc", window.float(),
                                 p["conv_w"].float())
                    + p["conv_b"].float())
        xBC_t = F.silu(conv_out)[:, None, :]                     # (B, 1, C)
        x, Bv, Cv = torch.split(xBC_t, splits, dim=-1)
        x = x.reshape(B_, 1, h, pdim)
        Bh = _expand_groups(Bv, cfg)                             # (B,1,H,N)
        Ch = _expand_groups(Cv, cfg)
        dt = F.softplus(dt_raw.float() + p["dt_bias"].float())   # (B,1,H)
        dA = torch.exp(dt[:, 0] * A)                             # (B,H)
        x_dt = x[:, 0] * dt[:, 0, :, None]                       # (B,H,P)
        state = (cache["ssm"] * dA[..., None, None]
                 + torch.einsum("bhn,bhp->bhpn", Bh[:, 0], x_dt))
        y = torch.einsum("bhn,bhpn->bhp", Ch[:, 0], state)[:, None]
        y = y + D * x
        cache["conv"].copy_(window[:, 1:])
        cache["ssm"].copy_(state)
    else:
        conv = F.silu(_causal_conv(xBC, p["conv_w"], p["conv_b"]))
        x, Bv, Cv = torch.split(conv, splits, dim=-1)
        x = x.reshape(B_, L, h, pdim).float()
        Bh = _expand_groups(Bv, cfg).float()
        Ch = _expand_groups(Cv, cfg).float()
        dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
        chunk = min(cfg.ssm_chunk, L)
        while L % chunk:
            chunk -= 1
        y, final_state = ssd_chunked(x, dt, A, Bh, Ch, chunk)
        y = y + D * x
        if cache is not None:
            W = cache["conv"].shape[1]
            tail = F.pad(xBC, (0, 0, max(W - L, 0), 0))[:, -W:]
            cache["conv"].copy_(tail)
            cache["ssm"].copy_(final_state)

    y = y.reshape(B_, L, din)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = y * F.silu(z.float())
    y = rmsnorm_apply({"scale": p["norm_scale"]}, y.to(u.dtype), cfg.rms_eps)
    return dense_apply(p["out_proj"], y), cache


def ssd_cache_init(batch: int, cfg: ModelConfig, device=None) -> Params:
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, _conv_dim(cfg)),
                            dtype=_dtype(cfg), device=device),
        "ssm": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_headdim,
                            cfg.ssm_state), dtype=torch.float32,
                           device=device),
    }
