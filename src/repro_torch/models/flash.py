"""Memory-efficient causal attention with a flash-style backward (the port
of ``repro.models.flash``).

Autodiff of online-softmax attention would keep every probability block
(the full B x H x L^2 matrix) for the backward. This autograd function
keeps only (q, k, v, out, m, l) -- O(B L H hd) -- and *recomputes* the
probability blocks chunk by chunk in the backward, as FlashAttention's
backward pass does.

The forward matches ``layers._attention_rect`` (same chunking, same
masking): an online softmax over KV chunks, one Q chunk at a time, with a
(B, q_chunk, KV, G, hd) f32 accumulator. It assumes attn_logit_softcap ==
0; ``layers.attention_apply`` takes the plain path when a softcap is set.
Inputs are computed on in f32 whatever their dtype; the output and the
gradients come back in q's dtype.
"""
from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def _fit(chunk: int, length: int) -> int:
    chunk = min(chunk, length)
    while length % chunk:
        chunk -= 1
    return chunk


def _fwd_impl(q, k, v, q_pos, k_pos, q_chunk, kv_chunk):
    """q (B, Lq, KV, G, hd), k, v (B, Lk, KV, hd), all f32. Returns out
    (B, Lq, KV, G, hd) f32 plus (m, l) (B, KV, G, Lq) f32."""
    B, Lq, KV, G, hd = q.shape
    kc = _fit(kv_chunk, k.shape[1])
    qc = _fit(q_chunk, Lq)
    nk = k.shape[1] // kc
    scale = 1.0 / math.sqrt(hd)
    outs, ms, ls = [], [], []
    for i in range(Lq // qc):
        q_blk = q[:, i * qc:(i + 1) * qc]
        qp = q_pos[i * qc:(i + 1) * qc]
        acc = q.new_zeros((B, qc, KV, G, hd))
        m = q.new_full((B, KV, G, qc), _NEG_INF)
        l = q.new_zeros((B, KV, G, qc))
        for j in range(nk):
            sl = slice(j * kc, (j + 1) * kc)
            s = torch.einsum("bqkgh,bskh->bkgqs", q_blk, k[:, sl]) * scale
            mask = k_pos[sl][None, :] <= qp[:, None]
            s = torch.where(mask, s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskh->bqkgh", p, v[:, sl])
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        outs.append(acc / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None])
        ms.append(m)
        ls.append(l)
    return torch.cat(outs, dim=1), torch.cat(ms, dim=-1), torch.cat(ls, dim=-1)


def _flash_bwd(q_chunk, kv_chunk, res, dout):
    qf, kf, vf, q_pos, k_pos, out, m, l = res
    B, Lq, KV, G, hd = qf.shape
    Lk = kf.shape[1]
    kc = _fit(kv_chunk, Lk)
    scale = 1.0 / math.sqrt(hd)
    do = dout.float()
    linv = 1.0 / l.clamp_min(1e-30)                          # (B,KV,G,Lq)
    # delta = sum_h dout * out  (B, KV, G, Lq)
    delta = torch.einsum("bqkgh,bqkgh->bkgq", do, out)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for j in range(Lk // kc):
        sl = slice(j * kc, (j + 1) * kc)
        k_blk, v_blk = kf[:, sl], vf[:, sl]
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, k_blk) * scale
        mask = k_pos[sl][None, :] <= q_pos[:, None]
        s = torch.where(mask, s, _NEG_INF)
        p = torch.exp(s - m[..., None]) * linv[..., None]    # (B,KV,G,Lq,kc)
        # dv_j = p^T dout
        dvs.append(torch.einsum("bkgqs,bqkgh->bskh", p, do))
        # dp = dout v^T ; ds = p * (dp - delta)
        dp = torch.einsum("bqkgh,bskh->bkgqs", do, v_blk)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bkgqs,bskh->bqkgh", ds, k_blk) * scale
        dks.append(torch.einsum("bkgqs,bqkgh->bskh", ds, qf) * scale)
    return dq, torch.cat(dks, dim=1), torch.cat(dvs, dim=1)


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, q_chunk, kv_chunk):
        qf, kf, vf = q.float(), k.float(), v.float()
        out, m, l = _fwd_impl(qf, kf, vf, q_pos, k_pos, q_chunk, kv_chunk)
        ctx.save_for_backward(qf, kf, vf, q_pos, k_pos, out, m, l)
        ctx.chunks = (q_chunk, kv_chunk)
        ctx.in_dtype = q.dtype
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _flash_bwd(*ctx.chunks, ctx.saved_tensors, dout)
        dt = ctx.in_dtype
        return dq.to(dt), dk.to(dt), dv.to(dt), None, None, None, None


def flash_attention(q, k, v, q_pos, k_pos, q_chunk: int = 2048,
                    kv_chunk: int = 4096) -> torch.Tensor:
    """q (B, Lq, KV, G, hd) f32/bf16; k, v (B, Lkv, KV, hd); positions 1-D.
    Returns (B, Lq, KV, G, hd) in q.dtype."""
    return _FlashAttention.apply(q, k, v, q_pos, k_pos, q_chunk, kv_chunk)
