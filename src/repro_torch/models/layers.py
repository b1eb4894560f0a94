"""Common neural layers on plain tensors (the port of
``repro.models.layers``).

Conventions, as the JAX package's:
* params are nested dicts of tensors; ``*_init(key, ...)`` builds them from
  a ``torch.Generator`` (drawn on the generator's device), ``*_apply(p,
  ...)`` runs them;
* activations flow in ``cfg.dtype`` (bf16), norms/softmax/rope accumulate in
  f32, params live in ``cfg.param_dtype`` (f32 master copies) and are cast
  to the activations' dtype at each use;
* where the JAX package asks a product of bf16 operands for an f32 result
  (``preferred_element_type``), both operands are upcast to f32 first, so
  the products are exact and the sums f32;
* attention is chunked (online softmax over KV blocks) so the (L, L) score
  matrix never materializes; local (sliding-window) attention slices a band
  per query chunk: O(L * window).

A cache passed to :func:`attention_apply` is written in place (prefill and
decode alike) and returned.

Tensor parallelism (``sharding.model_axis()`` bound: layout "tp", M > 1
ranks on ``model``). The layers run on this rank's slices of the
weights, as ``param_specs`` cuts them:

* ``wq`` / ``wk`` / ``wv``, ``w_gate`` / ``w_in`` are column-parallel (this
  rank's heads, this rank's d_ff / M columns; a bias, replicated, is
  sliced to the same columns) and ``wo`` / ``w_out`` row-parallel: their
  partial sums come out in f32 (bf16 operands upcast, so each product is
  exact) for the caller to reduce-scatter over ``model`` and round once;
* where the kv heads do not split over M (MQA, or GQA with fewer kv heads
  than ranks) ``param_specs`` still cuts ``wk`` / ``wv``'s columns in M,
  inside a head: the rank computes its columns, all-gathers them over
  ``model`` and holds K and V whole (the gradient comes back summed over
  ``model``), then takes the kv heads of its own query heads;
* where the query heads do not split over M either, ``wq``'s columns get
  the same treatment (gathered where ``param_specs`` cut them, inside a
  head, else computed whole), every rank runs every head, and each
  takes its own columns of the attention output into the rows of
  ``wo`` they meet (:func:`_own_rows`): the partial sums add up over
  ``model`` to the whole product, and each rank's gradient is its own
  part of the whole one;
* RoPE, M-RoPE and the q / k norms act on the heads a rank holds;
* the embedding is vocab-parallel: a lookup of this rank's vocab rows
  masked to its tokens, summed over ``model`` by the caller, and the LM
  head gives this rank's vocab slice of the logits.

The other mixers follow the same rules (their modules say how): the
RG-LRU runs on this rank's channels (its gates read the whole ``xi``,
all-gathered), the SSD on its heads (the packed ``in_proj`` columns,
cut off the heads by ``param_specs``, all-gathered first), the MoE on
its experts; each ends in a row-parallel f32 partial sum (``_row_apply``
for ``w_out`` / ``out_proj``, the MoE's combine over its own experts).
Two gradient traps go with them (``models.sharding``): the SSD's gated
RMSNorm takes its mean square as a sum over ``model`` that each rank
uses for its own channels, so its backward sums the gradient over
``model`` as well (``sharding.all_reduce``, not ``all_sum``); and the
MoE's load-balance loss, computed the same on every rank of ``model``
from the gathered sequence, would send its gradient M times, so each
rank takes its own L / M tokens' share of it.

A cache under tensor parallelism (``sharding.GridCache``) holds a KV
cache's length cut over ``model``: rank r the slots [r S / M, (r + 1) S
/ M) of every kv head (the whole cache where S does not split). Prefill
runs the attention as training does and hands each rank its slots'
keys and values of every kv head (gathered over ``model`` where the rank
computed its own heads), the local layer's ring keeping slot == pos % S.
Decode is flash-decode: the new token's q and k / v heads are
all-gathered over ``model``, the rank holding slot ``cur % S`` writes
it, every rank attends all heads over its own slots and keeps the
online-softmax partials (max, sum, f32 accumulator), and the partials,
all-gathered, are merged in rank order; each rank then takes its own
heads' rows into ``wo``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

_NEG_INF = -1e30

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def normal(key: torch.Generator, shape, dtype) -> torch.Tensor:
    if not isinstance(key, torch.Generator):    # shapes only: nothing drawn
        return torch.empty(shape, device=key.device, dtype=dtype)
    return torch.randn(shape, generator=key, device=key.device, dtype=dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def dense_init(key: torch.Generator, d_in: int, d_out: int,
               cfg: ModelConfig, bias: bool = False) -> Params:
    p = {"w": normal(key, (d_in, d_out), _pdtype(cfg)) / math.sqrt(d_in)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=_pdtype(cfg), device=key.device)
    return p


def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + sharding.local_slice(p["b"], y.shape[-1]).to(x.dtype)
    return y


class _RowPartial(torch.autograd.Function):
    """``x @ w`` in f32 from operands in the activations' dtype (each
    product exact, the sum f32), for the caller to reduce-scatter and
    round once; the backward is the one :func:`dense_apply`'s product has
    (the gradient arrives in the activations' dtype: two products in it),
    so the gradients round as one process rounds them."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).reshape(-1, w.shape[1])
        dx = (g @ w.t()).reshape(x.shape)
        dw = x.reshape(-1, w.shape[0]).t() @ g
        return dx, dw


def _row_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """A row-parallel dense layer: under tensor parallelism this rank's
    partial sum in f32 (:class:`_RowPartial`, the weight cast as
    :func:`dense_apply` casts it), else :func:`dense_apply`."""
    if sharding.model_axis() is None:
        return dense_apply(p, x)
    return _RowPartial.apply(x, p["w"].to(x.dtype))


def rmsnorm_init(d: int, cfg: ModelConfig,
                 device: Optional[torch.device] = None) -> Params:
    return {"scale": torch.ones((d,), dtype=_pdtype(cfg), device=device)}


def rmsnorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def _f32_product(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` with an f32 result: both operands upcast first."""
    return torch.einsum(eq, a.float(), b.float())


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------

def _freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> torch.Tensor:
    """positions (..., L) -> angles (..., L, head_dim//2) in f32."""
    freqs = _freqs(head_dim, theta, positions.device)
    return positions.float()[..., None] * freqs


def _mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                  sections: Tuple[int, ...]) -> torch.Tensor:
    """M-RoPE (Qwen2-VL): positions (B, 3, L) carry (temporal, h, w) ids;
    the head_dim//2 frequency slots are split into per-axis sections."""
    half = head_dim // 2
    assert sum(sections) == half, (sections, half)
    freqs = _freqs(head_dim, theta, positions.device)
    ang_all = positions.float()[..., None] * freqs               # (B,3,L,half)
    parts = []
    off = 0
    for axis, sec in enumerate(sections):
        parts.append(ang_all[:, axis, :, off:off + sec])
        off += sec
    return torch.cat(parts, dim=-1)                              # (B, L, half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               sections: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """x (B, L, H, hd); positions (B, L) or (B, 3, L) for M-RoPE."""
    hd = x.shape[-1]
    if sections is not None:
        ang = _mrope_angles(positions, hd, theta, sections)
    else:
        ang = _rope_angles(positions, hd, theta)
    cos = torch.cos(ang)[:, :, None, :]                          # (B,L,1,half)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention_init(key: torch.Generator, cfg: ModelConfig) -> Params:
    d, qd = cfg.d_model, cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    p = {
        "wq": dense_init(key, d, qd, cfg, bias=cfg.qkv_bias),
        "wk": dense_init(key, d, kvd, cfg, bias=cfg.qkv_bias),
        "wv": dense_init(key, d, kvd, cfg, bias=cfg.qkv_bias),
        "wo": dense_init(key, qd, d, cfg),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(cfg.head_dim, cfg, key.device)
        p["k_norm"] = rmsnorm_init(cfg.head_dim, cfg, key.device)
    return p


def _columns(p: Params, x: torch.Tensor, cfg: ModelConfig, heads: int
             ) -> torch.Tensor:
    """Q, K or V's columns (``heads`` heads): this rank's where the heads
    split over the model axis, else all of them (gathered over ``model``
    where ``param_specs`` cut them inside a head)."""
    y = dense_apply(p, x)
    ax = sharding.model_axis()
    if ax is not None and heads % ax.size \
            and y.shape[-1] != heads * cfg.head_dim:
        y = sharding.gather(y, ax, -1)
    return y


def _own_kv_heads(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig):
    """Under tensor parallelism with K and V held whole, the kv heads of
    this rank's query heads: a contiguous run when they group evenly,
    else one (repeated) kv head per query head; all of them where the
    query heads do not split (every rank runs every head)."""
    ax = sharding.model_axis()
    if ax is None or k.shape[2] != cfg.n_kv_heads or \
            cfg.n_kv_heads % ax.size == 0 or cfg.n_heads % ax.size:
        return k, v
    n_q = cfg.n_heads // ax.size
    group = cfg.n_heads // cfg.n_kv_heads
    idx = [h // group for h in range(ax.rank * n_q, (ax.rank + 1) * n_q)]
    lo, n_kv = idx[0], idx[-1] + 1 - idx[0]
    if n_q % n_kv == 0 and idx == [lo + j // (n_q // n_kv)
                                   for j in range(n_q)]:
        return k[:, :, lo:lo + n_kv], v[:, :, lo:lo + n_kv]
    sel = torch.tensor(idx, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def _qkv(p: Params, x: torch.Tensor, positions: torch.Tensor,
         cfg: ModelConfig, kind: str):
    B, L, _ = x.shape
    q = _columns(p["wq"], x, cfg, cfg.n_heads).reshape(B, L, -1,
                                                       cfg.head_dim)
    k = _columns(p["wk"], x, cfg, cfg.n_kv_heads).reshape(B, L, -1,
                                                          cfg.head_dim)
    v = _columns(p["wv"], x, cfg, cfg.n_kv_heads).reshape(B, L, -1,
                                                          cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm_apply(p["q_norm"], q, cfg.rms_eps)
        k = rmsnorm_apply(p["k_norm"], k, cfg.rms_eps)
    theta = cfg.rope_theta_local if kind == "local" else cfg.rope_theta
    q = apply_rope(q, positions, theta, cfg.mrope_sections)
    k = apply_rope(k, positions, theta, cfg.mrope_sections)
    return q, k, v


def _all_kv_heads(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig):
    """Every kv head of K and V: all-gathered over ``model`` where this
    rank computed its own."""
    if k.shape[2] == cfg.n_kv_heads:
        return k, v
    ax = sharding.model_axis()
    return sharding.gather(k, ax, 2), sharding.gather(v, ax, 2)


def _fit_chunk(chunk: int, length: int) -> int:
    """Largest divisor of ``length`` that is <= chunk."""
    chunk = min(chunk, length)
    while length % chunk:
        chunk -= 1
    return chunk


def _scores(q: torch.Tensor, k: torch.Tensor, softcap: float
            ) -> torch.Tensor:
    """q (B, qc, KV, G, hd), k (B, kc, KV, hd) -> (B, KV, G, qc, kc) f32."""
    s = _f32_product("bqkgh,bskh->bkgqs", q, k)
    s = s / math.sqrt(q.shape[-1])
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    return s


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Probabilities rounded to v's dtype, times v, summed in f32:
    (B, KV, G, qc, s), (B, s, KV, hd) -> (B, qc, KV, G, hd)."""
    return _f32_product("bkgqs,bskh->bqkgh", p.to(v.dtype), v)


def _attention_rect(q, k, v, q_pos, k_pos, cfg: ModelConfig, kv_chunk: int,
                    q_chunk: int = 2048) -> torch.Tensor:
    """Online softmax over KV chunks (the full causal rectangle, masked),
    one Q chunk at a time so the f32 accumulator is (B, q_chunk, H, hd).

    q (B, Lq, H, hd); k, v (B, Lkv, KV, hd); q_pos (Lq,), k_pos (Lkv,).
    The path of a positive ``attn_logit_softcap``."""
    B, Lq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    q_chunk = _fit_chunk(q_chunk, Lq)
    nk = k.shape[1] // kv_chunk
    outs = []
    for i in range(Lq // q_chunk):
        qp = q_pos[i * q_chunk:(i + 1) * q_chunk]
        qg = q[:, i * q_chunk:(i + 1) * q_chunk].reshape(
            B, q_chunk, KV, G, hd)
        acc = torch.zeros((B, q_chunk, KV, G, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, KV, G, q_chunk), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KV, G, q_chunk), dtype=torch.float32,
                        device=q.device)
        for j in range(nk):
            sl = slice(j * kv_chunk, (j + 1) * kv_chunk)
            s = _scores(qg, k[:, sl], cfg.attn_logit_softcap)
            mask = k_pos[sl][None, :] <= qp[:, None]             # (qc, kc)
            s = torch.where(mask, s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + _pv(p, v[:, sl])
            m = m_new
        out = acc / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
        outs.append(out.reshape(B, q_chunk, H, hd).to(q.dtype))
    return torch.cat(outs, dim=1)


def _attention_banded(q, k, v, q_pos, k_pos, cfg: ModelConfig,
                      q_chunk: int) -> torch.Tensor:
    """Sliding-window attention: each q chunk attends to a static-width band
    [chunk_start - window, chunk_end). O(L * window) compute."""
    B, L, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    w = cfg.window
    q_chunk = min(q_chunk, L)
    # pad keys left by w so every band slice is in bounds
    kp = F.pad(k, (0, 0, 0, 0, w, 0))
    vp = F.pad(v, (0, 0, 0, 0, w, 0))
    kpos_p = F.pad(k_pos + 1, (w, 0)) - 1     # padded slots get pos -1
    outs = []
    for i in range(L // q_chunk):
        start = i * q_chunk
        qp = q_pos[start:start + q_chunk]
        q_blk = q[:, start:start + q_chunk].reshape(B, q_chunk, KV, G, hd)
        band = slice(start, start + w + q_chunk)
        kp_band = kpos_p[band]
        s = _scores(q_blk, kp[:, band], cfg.attn_logit_softcap)
        mask = ((kp_band[None, :] <= qp[:, None]) &
                (kp_band[None, :] > qp[:, None] - w) &
                (kp_band[None, :] >= 0))
        s = torch.where(mask, s, _NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1)
        pv = _pv(p, vp[:, band])
        out = pv / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
        outs.append(out.reshape(B, q_chunk, H, hd).to(q.dtype))
    return torch.cat(outs, dim=1)


def _attention_decode(q, k_cache, v_cache, slot_pos, cur_pos,
                      cfg: ModelConfig, kind: str) -> torch.Tensor:
    """Single-token decode against a cache. q (B, 1, H, hd);
    k/v_cache (B, S, KV, hd); slot_pos (B, S) absolute position held by each
    cache slot (-1 = empty); cur_pos (B,) per-sequence positions."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, 1, KV, G, hd)
    s = _scores(qg, k_cache, cfg.attn_logit_softcap)            # (B,KV,G,1,S)
    valid = (slot_pos >= 0) & (slot_pos <= cur_pos[:, None])
    if kind == "local":
        valid &= slot_pos > (cur_pos[:, None] - cfg.window)
    s = torch.where(valid[:, None, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _pv(p, v_cache).reshape(B, 1, H, hd).to(q.dtype)


def _quant_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 KV quantization, per (batch, slot, head) absmax scale; rounds
    half to even and clips to +-127."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequant_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


@dataclasses.dataclass(frozen=True)
class CacheLeaf:
    """One cache leaf's shape, dtype and fill value, nothing allocated: a
    cache's layout (``sharding.cache_specs`` reads its shape), which
    :func:`allocate` makes."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    fill: int = 0


def allocate(layout: Dict[str, CacheLeaf], device=None) -> Params:
    """The leaves of ``layout``, each filled with its value."""
    return {k: torch.full(v.shape, v.fill, dtype=v.dtype, device=device)
            for k, v in layout.items()}


@dataclasses.dataclass(frozen=True)
class AttnCacheSpec:
    """Cache layout for one attention layer: ring buffer of ``size`` slots
    (size == window for local layers, max_len for global). With
    cfg.kv_cache_dtype == "int8" the K/V payloads are quantized with
    per-(slot, head) f32 scales."""
    size: int

    def layout(self, batch: int, cfg: ModelConfig) -> Dict[str, CacheLeaf]:
        kvd = (batch, self.size, cfg.n_kv_heads, cfg.head_dim)
        pos = CacheLeaf((batch, self.size), torch.int32, -1)
        if cfg.kv_cache_dtype == "int8":
            sc = (batch, self.size, cfg.n_kv_heads)
            return {"k": CacheLeaf(kvd, torch.int8),
                    "v": CacheLeaf(kvd, torch.int8),
                    "k_scale": CacheLeaf(sc, torch.float32),
                    "v_scale": CacheLeaf(sc, torch.float32),
                    "pos": pos}
        return {"k": CacheLeaf(kvd, _dtype(cfg)),
                "v": CacheLeaf(kvd, _dtype(cfg)), "pos": pos}

    def init(self, batch: int, cfg: ModelConfig, device=None) -> Params:
        return allocate(self.layout(batch, cfg), device)


def attention_apply(p: Params, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, kind: str,
                    cache: Optional[Params] = None, q_chunk: int = 2048,
                    kv_chunk: int = 4096, cut: bool = False):
    """Modes: cache is None -> training/scoring full pass (returns y, None).
    cache given & L > 1 -> prefill (fills the cache). cache given & L == 1
    -> single-token decode (updates the ring cache). Under tensor
    parallelism ``cut`` says whether the cache's length is cut over
    ``model`` (``sharding.length_cut``)."""
    B, L, _ = x.shape
    q, k_held, v_held = _qkv(p, x, positions, cfg, kind)
    k, v = _own_kv_heads(k_held, v_held, cfg)

    int8_cache = cfg.kv_cache_dtype == "int8"
    ax = sharding.model_axis()
    if cache is not None and L == 1 and ax is not None:
        k, v = _all_kv_heads(k_held, v_held, cfg)
        y = _decode_on_grid(q, k, v, cache, positions, cfg, kind, cut, ax)
    elif cache is not None and L == 1:
        cur = positions[:, -1] if positions.dim() == 2 else positions[:, 0, -1]
        S = cache["pos"].shape[1]
        slot = (cur % S).long()                                  # (B,)
        bidx = torch.arange(B, device=x.device)
        if int8_cache:
            kq, ksc = _quant_kv(k[:, 0])
            vq, vsc = _quant_kv(v[:, 0])
            cache["k"][bidx, slot] = kq
            cache["v"][bidx, slot] = vq
            cache["k_scale"][bidx, slot] = ksc
            cache["v_scale"][bidx, slot] = vsc
            k_cache = _dequant_kv(cache["k"], cache["k_scale"], k.dtype)
            v_cache = _dequant_kv(cache["v"], cache["v_scale"], v.dtype)
        else:
            cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
            cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
            k_cache, v_cache = cache["k"], cache["v"]
        cache["pos"][bidx, slot] = cur.to(torch.int32)
        y = _attention_decode(q, k_cache, v_cache, cache["pos"], cur, cfg,
                              kind)
    else:
        q_pos = positions[0] if positions.dim() == 2 else positions[0, 0]
        kv_chunk = _fit_chunk(kv_chunk, L)
        q_chunk = _fit_chunk(q_chunk, L)
        if kind == "local":
            y = _attention_banded(q, k, v, q_pos, q_pos, cfg, q_chunk)
        elif cfg.attn_logit_softcap == 0.0:
            # flash path: O(B L H hd) saved for the backward, probability
            # blocks recomputed there (repro_torch.models.flash)
            from repro_torch.models.flash import flash_attention
            KV = k.shape[2]
            qg = q.reshape(B, L, KV, q.shape[2] // KV, cfg.head_dim)
            y = flash_attention(qg, k, v, q_pos, q_pos, q_chunk,
                                kv_chunk).reshape(q.shape)
        else:
            y = _attention_rect(q, k, v, q_pos, q_pos, cfg, kv_chunk)
        if cache is not None and ax is not None:
            k, v = _all_kv_heads(k_held, v_held, cfg)
            _prefill_cache(cache, k, v, q_pos, int8_cache,
                           *_slots(cache, cut, ax))
        elif cache is not None:
            _prefill_cache(cache, k, v, q_pos, int8_cache)

    y = y.reshape(B, L, -1)
    wo = p["wo"]
    if ax is not None and cfg.n_heads % ax.size:
        wo, y = _own_rows(wo, y, ax)
    return _row_apply(wo, y), cache


def _own_rows(wo: Params, y: torch.Tensor, ax) -> Tuple[Params, torch.Tensor]:
    """Where the heads do not split over ``model`` every rank holds the
    attention output of every head: this rank's columns of it and the
    rows of ``wo`` they meet, so that the partial sums add up over
    ``model`` to the whole product. ``wo``'s rows as ``param_specs`` cut
    them (inside a head), or, where its rows stay whole, rows r n / M ..
    (r + 1) n / M of its n on rank r."""
    w, n = wo["w"], y.shape[-1]
    if w.shape[0] != n:
        return wo, sharding.local_slice(y, w.shape[0])
    lo, hi = ax.rank * n // ax.size, (ax.rank + 1) * n // ax.size
    return {"w": w[lo:hi]}, y[..., lo:hi]


def _slots(cache: Params, cut: bool, ax) -> Tuple[int, int]:
    """(first slot this rank holds, slots of the whole cache): rank r's
    S / M where the length is cut over ``model``, else all of them."""
    s = cache["pos"].shape[1]
    return (ax.rank * s, s * ax.size) if cut else (0, s)


def _prefill_cache(cache: Params, k, v, q_pos, int8_cache: bool,
                   lo: int = 0, S: Optional[int] = None) -> None:
    """Write a prefill's keys and values into ``cache``, which holds slots
    ``lo`` .. of a cache of ``S`` (default: all of them): the first L
    slots, or, when the sequence is longer than the cache (a local layer's
    ring), its last S tokens aligned so that slot == pos % S."""
    B, L = k.shape[:2]
    s = cache["pos"].shape[1]
    S = s if S is None else S
    kw, vw = k, v
    payload = {}
    if int8_cache:
        kw, payload["k_scale"] = _quant_kv(k)
        vw, payload["v_scale"] = _quant_kv(v)
    payload["k"], payload["v"] = kw, vw
    payload["pos"] = q_pos.to(torch.int32)[None].expand(B, L)
    for name, val in payload.items():
        if S >= L:
            n = min(max(L - lo, 0), s)
            cache[name][:, :n] = val[:, lo:lo + n].to(cache[name].dtype)
        else:
            # slot j holds the position in [L - S, L) that is j mod S
            j = torch.arange(lo, lo + s, device=val.device)
            cache[name].copy_(val[:, L - S + (j - (L - S)) % S])


def _decode_on_grid(q, k, v, cache: Params, positions, cfg: ModelConfig,
                    kind: str, cut: bool, ax) -> torch.Tensor:
    """One decode step against a cache whose length is cut over ``model``
    (``cut``) or whole on every rank: q (B, 1, H / M, hd) this rank's
    heads (every head, already gathered, where the heads do not split),
    k / v (B, 1, KV, hd) every kv head. Returns the attention output of
    q's heads."""
    B, _, hq, hd = q.shape
    own = hq != cfg.n_heads
    if own:
        q = sharding.gather(q, ax, 2)                    # (B, 1, H, hd)
    cur = positions[:, -1] if positions.dim() == 2 else positions[:, 0, -1]
    lo, S = _slots(cache, cut, ax)
    s = cache["pos"].shape[1]
    slot = (cur % S).long() - lo
    mine = (slot >= 0) & (slot < s)                      # this rank's rows
    bidx = torch.arange(B, device=q.device)
    slot = slot.clamp(0, s - 1)

    def put(name, val):
        old = cache[name][bidx, slot]
        keep = mine.reshape((B,) + (1,) * (old.dim() - 1))
        cache[name][bidx, slot] = torch.where(keep, val.to(old.dtype), old)

    if cfg.kv_cache_dtype == "int8":
        kq, ksc = _quant_kv(k[:, 0])
        vq, vsc = _quant_kv(v[:, 0])
        put("k", kq)
        put("v", vq)
        put("k_scale", ksc)
        put("v_scale", vsc)
        k_cache = _dequant_kv(cache["k"], cache["k_scale"], k.dtype)
        v_cache = _dequant_kv(cache["v"], cache["v_scale"], v.dtype)
    else:
        put("k", k[:, 0])
        put("v", v[:, 0])
        k_cache, v_cache = cache["k"], cache["v"]
    put("pos", cur.to(torch.int32))

    # this rank's slots, every head: the online-softmax partials
    KV = k_cache.shape[2]
    H = q.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, hd)
    sc = _scores(qg, k_cache, cfg.attn_logit_softcap)     # (B,KV,G,1,s)
    slot_pos = cache["pos"]
    valid = (slot_pos >= 0) & (slot_pos <= cur[:, None])
    if kind == "local":
        valid &= slot_pos > (cur[:, None] - cfg.window)
    valid = valid[:, None, None, None, :]
    m = torch.where(valid, sc, _NEG_INF).amax(dim=-1)    # (B,KV,G,1)
    pr = torch.where(valid, torch.exp(sc - m[..., None]), 0.0)
    l = pr.sum(dim=-1)
    acc = _pv(pr, v_cache)                               # (B,1,KV,G,hd)
    if cut:
        # the ranks' partials merged in rank order by log-sum-exp
        ms, ls, accs = (ax.all_gather(t) for t in (m, l, acc))
        m = ms.amax(dim=0)
        w = torch.exp(ms - m)                            # (M,B,KV,G,1)
        l = (w * ls).sum(dim=0)
        acc = (w.permute(0, 1, 4, 2, 3)[..., None] * accs).sum(dim=0)
    out = acc / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    out = out.reshape(B, 1, H, hd).to(q.dtype)
    return out[:, :, ax.rank * hq:(ax.rank + 1) * hq] if own else out


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp_init(key: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> Params:
    d_ff = d_ff or cfg.d_ff
    p = {
        "w_in": dense_init(key, cfg.d_model, d_ff, cfg),
        "w_out": dense_init(key, d_ff, cfg.d_model, cfg),
    }
    if cfg.mlp_gated:
        p["w_gate"] = dense_init(key, cfg.d_model, d_ff, cfg)
    return p


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = F.silu if cfg.mlp_act == "silu" else gelu
    if cfg.mlp_gated:
        g = act(dense_apply(p["w_gate"], x))
        return _row_apply(p["w_out"], g * dense_apply(p["w_in"], x))
    return _row_apply(p["w_out"], act(dense_apply(p["w_in"], x)))


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embedding_init(key: torch.Generator, cfg: ModelConfig) -> Params:
    return {"table": normal(key, (cfg.vocab_padded, cfg.d_model),
                            _pdtype(cfg)) * 0.02}


def embedding_apply(p: Params, tokens: torch.Tensor, cfg: ModelConfig
                    ) -> torch.Tensor:
    """tokens (B, L) -> (B, L, d); under tensor parallelism (B, L / M, d):
    this rank's vocab rows looked up where they hold the token, summed
    over ``model`` and reduce-scattered onto the sequence (every other
    rank adds zeros, so the sum is the row itself); all of (B, L, d)
    where the sequence runs whole (``sharding.seq_axis()`` None)."""
    ax = sharding.model_axis()
    if ax is None:
        x = p["table"][tokens.long()]
    else:
        n = p["table"].shape[0]
        local = tokens.long() - ax.rank * n
        mine = (local >= 0) & (local < n)
        x = torch.where(mine[..., None], p["table"][local.clamp(0, n - 1)],
                        0.0)
        x = (sharding.all_sum(x, ax) if sharding.seq_axis() is None
             else sharding.scatter(x, ax, 1))
    x = x.to(_dtype(cfg))
    if cfg.emb_scale_by_sqrt_dim:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def lm_head_apply(p: Params, x: torch.Tensor, cfg: ModelConfig
                  ) -> torch.Tensor:
    """x (B, L, d) -> logits (B, L, vocab_padded) in f32; under tensor
    parallelism this rank's vocab slice of them."""
    logits = x.float() @ p["table"].to(x.dtype).float().T
    if cfg.final_logit_softcap > 0.0:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits
