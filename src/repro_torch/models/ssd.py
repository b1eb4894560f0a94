"""Mamba-2 SSD (state-space duality) mixer, chunked (the port of
``repro.models.ssd``).

The chunked formulation (Dao & Gu 2024, Sec. 6) splits the sequence into
chunks: intra-chunk interactions are a masked (chunk x chunk) matmul, and
inter-chunk interactions flow through a small (H, P, N) state carried from
chunk to chunk. Decode keeps (conv_state, ssm_state) and costs O(1) per
token. A cache passed to :func:`ssd_apply` is written in place and
returned.

Under tensor parallelism (``sharding.model_axis()``) a rank runs its
``ssm_nheads / M`` heads. ``param_specs`` cuts the packed ``in_proj``
columns ``[z | x | B | C | dt]`` and the conv's ``x | B | C`` channels
into M contiguous blocks that are not head-aligned, and keeps that layout
(checkpoints and the dry run's bytes are the JAX package's): a rank
computes its columns and all-gathers them over ``model`` (the gradient
comes back reduce-scattered), as it gathers the conv's weights, then
takes its heads of ``z``, ``x`` and ``dt`` and ``B`` / ``C`` whole, and
runs the conv on those channels. ``A_log``, ``D`` and ``dt_bias`` are cut
by heads. The gated RMSNorm normalises over the whole ``d_inner``: its
mean square is the sum over ``model`` of each rank's partial sums
(``sharding.all_reduce``, whose backward sums the gradient over
``model``: each rank goes on with its own channels). ``out_proj`` is
row-parallel: its partial sum comes out in f32 for the block to
reduce-scatter. Where ``in_proj`` or ``conv_w`` columns do not split,
``param_specs`` keeps them whole and no gather is needed.

A cache under tensor parallelism holds ``ssm`` by heads (this rank's)
and ``conv`` as ``sharding.cache_specs`` cuts it: a contiguous C / M
slice of the packed ``x | B | C`` channels, which is not the channels
this rank's heads use. A decode step all-gathers the conv window over
``model`` (B x (K - 1) x C values), convolves its own channels and
writes its slice of the new window back; a prefill writes its slice of
the last K - 1 inputs. Where C does not split the window is whole on
every rank.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (CacheLeaf, _dtype, _pdtype,
                                       _row_apply, allocate, dense_apply,
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


def _whole(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x``'s last dim whole: all-gathered over ``model`` where
    ``param_specs`` cut it (``width`` the full size)."""
    if x.shape[-1] == width:
        return x
    return sharding.gather(x, sharding.model_axis(), -1)


def _head_range(cfg: ModelConfig) -> Tuple[int, int]:
    """(first head, head count) of this rank: all of them without tensor
    parallelism."""
    ax = sharding.model_axis()
    if ax is None:
        return 0, cfg.ssm_nheads
    n = cfg.ssm_nheads // ax.size
    return ax.rank * n, n


def _own_channels(cfg: ModelConfig, t: torch.Tensor, lo: int, n: int
                  ) -> torch.Tensor:
    """Of ``t``'s packed ``x | B | C`` channels (last dim), the x channels
    of heads ``lo`` .. ``lo + n`` and B / C whole."""
    if n == cfg.ssm_nheads:
        return t
    din, P = cfg.ssm_dinner, cfg.ssm_headdim
    return torch.cat([t[..., lo * P:(lo + n) * P], t[..., din:]], dim=-1)


def _own_heads(cfg: ModelConfig, zxbcdt: torch.Tensor, conv_w, conv_b,
               lo: int, n: int):
    """Heads ``lo`` .. ``lo + n`` of the whole in_proj output: (z, xBC,
    dt_raw, conv_w, conv_b) with xBC those heads' x channels and B / C
    whole, and the conv's weights on those channels."""
    z, xBC, dt_raw = _split_in_proj(cfg, zxbcdt)
    if n == cfg.ssm_nheads:
        return z, xBC, dt_raw, conv_w, conv_b
    P = cfg.ssm_headdim
    return (z[..., lo * P:(lo + n) * P], _own_channels(cfg, xBC, lo, n),
            dt_raw[..., lo:lo + n], _own_channels(cfg, conv_w, lo, n),
            _own_channels(cfg, conv_b, lo, n))


def _write_conv(cache: Params, window: torch.Tensor) -> None:
    """Write the whole conv window (B, K - 1, C) into ``cache["conv"]``:
    this rank's slice of the channels where the cache holds one."""
    c = cache["conv"].shape[-1]
    if c != window.shape[-1]:
        window = window.narrow(-1, sharding.model_axis().rank * c, c)
    cache["conv"].copy_(window)


def _gated_norm(scale: torch.Tensor, y: torch.Tensor, eps: float
                ) -> torch.Tensor:
    """The gated RMSNorm over the whole ``d_inner`` from this rank's
    channels ``y``: the mean square summed over ``model``."""
    ax = sharding.model_axis()
    if ax is None:
        return rmsnorm_apply({"scale": scale}, y, eps)
    yf = y.float()
    ss = sharding.all_reduce(torch.sum(yf * yf, dim=-1, keepdim=True), ax)
    var = ss / (y.shape[-1] * ax.size)
    out = yf * torch.rsqrt(var + eps)
    return (out * sharding.local_slice(scale, y.shape[-1]).float()
            ).to(y.dtype)


def ssd_apply(p: Params, u: torch.Tensor, cfg: ModelConfig,
              cache: Optional[Params] = None
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Full SSD block: in_proj -> causal conv -> SSD -> gated norm ->
    out_proj. u (B, L, d). With a cache and L == 1, runs the O(1) decode
    step; with a cache and L > 1, runs the chunked prefill and writes the
    final (conv, ssm) states into the cache."""
    B_, L, _ = u.shape
    pdim, n = cfg.ssm_headdim, cfg.ssm_state
    gn = cfg.ssm_ngroups * n
    zxbcdt = _whole(dense_apply(p["in_proj"], u),
                    2 * cfg.ssm_dinner + 2 * gn + cfg.ssm_nheads)
    h0, h = _head_range(cfg)             # ssm_nheads / M heads under TP
    z, xBC, dt_raw, conv_w, conv_b = _own_heads(
        cfg, zxbcdt, _whole(p["conv_w"], _conv_dim(cfg)), p["conv_b"],
        h0, h)
    xBC_all = _split_in_proj(cfg, zxbcdt)[1]     # every head's channels
    din = h * pdim
    splits = [din, gn, gn]
    A = -torch.exp(sharding.local_slice(p["A_log"], h).float())
    D = sharding.local_slice(p["D"], h).float()[None, None, :, None]
    dt_bias = sharding.local_slice(p["dt_bias"], h).float()

    def heads(v):                        # (..., G*N) -> this rank's heads
        return _expand_groups(v, cfg)[..., h0:h0 + h, :]

    if cache is not None and L == 1:
        # the window of every channel (gathered over ``model`` where the
        # cache holds a slice), this rank's channels convolved
        hist = _whole(cache["conv"], _conv_dim(cfg))
        full = torch.cat([hist, xBC_all.to(hist.dtype)], dim=1)  # (B, W, C)
        window = _own_channels(cfg, full, h0, h)
        conv_out = (torch.einsum("bwc,wc->bc", window.float(),
                                 conv_w.float())
                    + conv_b.float())
        xBC_t = F.silu(conv_out)[:, None, :]                     # (B, 1, C)
        x, Bv, Cv = torch.split(xBC_t, splits, dim=-1)
        x = x.reshape(B_, 1, h, pdim)
        Bh = heads(Bv)                                           # (B,1,H,N)
        Ch = heads(Cv)
        dt = F.softplus(dt_raw.float() + dt_bias)                # (B,1,H)
        dA = torch.exp(dt[:, 0] * A)                             # (B,H)
        x_dt = x[:, 0] * dt[:, 0, :, None]                       # (B,H,P)
        state = (cache["ssm"] * dA[..., None, None]
                 + torch.einsum("bhn,bhp->bhpn", Bh[:, 0], x_dt))
        y = torch.einsum("bhn,bhpn->bhp", Ch[:, 0], state)[:, None]
        y = y + D * x
        _write_conv(cache, full[:, 1:])
        cache["ssm"].copy_(state)
    else:
        conv = F.silu(_causal_conv(xBC, conv_w, conv_b))
        x, Bv, Cv = torch.split(conv, splits, dim=-1)
        x = x.reshape(B_, L, h, pdim).float()
        Bh = heads(Bv).float()
        Ch = heads(Cv).float()
        dt = F.softplus(dt_raw.float() + dt_bias)
        chunk = min(cfg.ssm_chunk, L)
        while L % chunk:
            chunk -= 1
        y, final_state = ssd_chunked(x, dt, A, Bh, Ch, chunk)
        y = y + D * x
        if cache is not None:
            W = cache["conv"].shape[1]
            _write_conv(cache, F.pad(xBC_all, (0, 0, max(W - L, 0), 0))
                        [:, -W:])
            cache["ssm"].copy_(final_state)

    y = y.reshape(B_, L, din)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = y * F.silu(z.float())
    y = _gated_norm(p["norm_scale"], y.to(u.dtype), cfg.rms_eps)
    return _row_apply(p["out_proj"], y), cache


def ssd_cache_layout(batch: int, cfg: ModelConfig) -> Dict[str, CacheLeaf]:
    return {
        "conv": CacheLeaf((batch, cfg.conv_width - 1, _conv_dim(cfg)),
                          _dtype(cfg)),
        "ssm": CacheLeaf((batch, cfg.ssm_nheads, cfg.ssm_headdim,
                          cfg.ssm_state), torch.float32),
    }


def ssd_cache_init(batch: int, cfg: ModelConfig, device=None) -> Params:
    return allocate(ssd_cache_layout(batch, cfg), device)
