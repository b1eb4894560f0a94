"""Gradient compression for data parallelism across slow links (the port
of ``repro.optim.compression``) -- the same communication-reduction theme
as the paper, applied to the training plane.

Two schemes, both with error feedback (the residual of the lossy step is
carried to the next step, preserving convergence):

* int8 quantization: per-tensor absmax scale, 4x fewer bytes on the wire
  than f32 (2x vs bf16).
* top-k sparsification: keep the k largest-|g| entries per tensor.

``compressed_psum`` applies quantize -> sum over the ranks of a mesh axis
-> dequantize, so the collective itself moves integers: where the JAX
package calls ``lax.psum`` inside ``shard_map``, the port all-gathers over
the bound :class:`repro_torch.core.mesh.Mesh` axis and sums in rank order.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch import tree as tree_mod
from repro_torch.core.mesh import axis

PyTree = Any


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def qdq_int8(g: torch.Tensor) -> torch.Tensor:
    q, s = quantize_int8(g)
    return dequantize_int8(q, s)


def topk_mask(g: torch.Tensor, frac: float) -> torch.Tensor:
    """Keep the top-``frac`` fraction of entries by magnitude."""
    flat = torch.abs(g.reshape(-1))
    k = max(int(flat.shape[0] * frac), 1)
    thresh = torch.topk(flat, k).values[-1]
    return (torch.abs(g) >= thresh).to(g.dtype)


def compress_with_feedback(
    grads: PyTree,
    error: Optional[PyTree],
    scheme: str = "int8",
    topk_frac: float = 0.01,
) -> Tuple[PyTree, PyTree]:
    """Returns (compressed_grads, new_error). ``error`` accumulates what the
    lossy representation dropped; it is added back before compressing."""
    if scheme not in ("int8", "topk"):
        raise ValueError(scheme)
    if error is None:
        error = tree_mod.map(
            lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

    def one(g, e):
        gf = g.to(torch.float32) + e
        comp = qdq_int8(gf) if scheme == "int8" else \
            gf * topk_mask(gf, topk_frac)
        return comp.to(g.dtype), gf - comp

    out = [one(g, e) for g, e in zip(tree_mod.leaves(grads),
                                     tree_mod.leaves(error))]
    return (tree_mod.unflatten(grads, [c for c, _ in out]),
            tree_mod.unflatten(grads, [e for _, e in out]))


def compressed_psum(grads: PyTree, axis_name: str) -> PyTree:
    """int8-on-the-wire gradient all-reduce over the bound mesh axis
    ``axis_name``: quantize -> sum of the ranks' int8 payloads as int32 ->
    dequantize with the mean of the ranks' scales (a shared scale
    approximation). Call on every rank of the axis, inside ``with mesh:``
    (``repro_torch.core.mesh.launch`` binds it)."""
    mesh = axis(axis_name)

    def one(g):
        q, s = quantize_int8(g.to(torch.float32))
        qsum = mesh.all_gather(q.to(torch.int32)).sum(0, dtype=torch.int32)
        ssum = mesh.all_gather(s).sum(0)
        n = torch.tensor(float(mesh.size), dtype=torch.float32,
                         device=g.device)
        return (qsum.to(torch.float32) * (ssum / n)).to(g.dtype)

    return tree_mod.map(one, grads)
