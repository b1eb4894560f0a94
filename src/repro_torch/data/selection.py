"""Coreset-based distributed data selection (the port of
``repro.data.selection``) -- the paper's technique as a feature of the
training data pipeline.

Each data-parallel shard holds a pool of candidate examples. Examples are
embedded (mean-pooled token embeddings from the model's own embedding
table), and Algorithm 1 runs over the embedding space: local k-means solves,
a single scalar (local cost) exchanged per shard, then cost-proportional
sensitivity sampling. The selected examples + per-example weights form a
coverage-preserving training subset whose weighted loss approximates the
full-pool loss for *any* model state in the embedding space's cost
geometry -- at a communication cost of one scalar per shard plus the subset
itself (vs shipping every shard's pool).

Returns example *indices* (not just points), because the trainer needs to
fetch the actual sequences. The local solves run for all shards at once
through the dispatch layer (one kernel launch per seeding or Lloyd step on
the card), as ``jax.vmap`` over shards does in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import clustering
from repro_torch.core import objective as objective_mod
from repro_torch.core import prng
from repro_torch.core.backend import BackendLike, DeviceLike, as_tensor
from repro_torch.core.coreset import (_windowed_sum, proportional_allocation,
                                      weighted_choice)

_TINY = 1e-30
# bytes of the gathered (examples, L, d) float32 block one chunk of
# embed_examples may hold: the whole pool's block can run to 100+ GB
EMBED_CHUNK_BYTES = 2 ** 31


def embed_examples(embed_table, tokens,
                   device: DeviceLike = None) -> torch.Tensor:
    """Mean-pooled token embeddings: tokens (..., L) -> (..., d) f32.

    Examples go through in chunks whose gathered (chunk, L, d) float32
    block stays within :data:`EMBED_CHUNK_BYTES`: each chunk indexes the
    table, then takes the float32 mean over L. Every example's result is
    the same whatever the chunking. Runs on ``device`` (CUDA unless the
    caller asks for the CPU)."""
    dev = backend_mod.resolve_device(device)
    table = as_tensor(embed_table, dev)
    tokens = as_tensor(tokens, dev)
    lead, L, d = tokens.shape[:-1], tokens.shape[-1], table.shape[-1]
    flat = tokens.reshape(-1, L)
    per = max(1, EMBED_CHUNK_BYTES // max(1, L * d * 4))
    out = torch.empty((flat.shape[0], d), dtype=torch.float32, device=dev)
    for s in range(0, flat.shape[0], per):
        out[s:s + per] = table[flat[s:s + per]].to(torch.float32).mean(-2)
    return out.reshape(*lead, d)


@dataclasses.dataclass
class Selection:
    """Per-site selected example indices and weights. Invalid slots have
    weight exactly 0 (their index is arbitrary)."""

    indices: torch.Tensor      # (n_sites, t_buffer + k) int32, site-local
    weights: torch.Tensor      # (n_sites, t_buffer + k) f32
    t_i: torch.Tensor          # (n_sites,)
    local_costs: torch.Tensor  # (n_sites,)


def select_coreset(
    key,
    embeddings,          # (n_sites, M, d) f32
    mask,                # (n_sites, M) bool
    k: int,
    t: int,
    t_buffer: Optional[int] = None,
    lloyd_iters: int = 5,
    backend: BackendLike = None,
    device: DeviceLike = None,
) -> Selection:
    """Algorithm 1 over example embeddings, returning indices.

    The coreset's "solution centers" are mapped back to data: the example
    nearest each local center joins the selection, carrying the center
    weight w_b = |P_b| - sum_{q in P_b cap S} w_q. Runs on ``device``
    (CUDA unless the caller asks for the CPU)."""
    t_buffer = t if t_buffer is None else t_buffer
    dev = backend_mod.resolve_device(device)
    key = as_tensor(key, dev)
    embeddings = as_tensor(embeddings, dev)
    w_site = as_tensor(mask, dev).to(torch.float32)
    n_sites = embeddings.shape[0]
    keys = prng.split(key, 2 * n_sites).reshape(n_sites, 2, 2)
    m, assign, center_idx = _local_solves(
        keys[:, 0], embeddings, w_site, k, lloyd_iters,
        backend_mod.get_backend(backend, dev))
    local_costs = _windowed_sum(m)
    t_i = proportional_allocation(local_costs, t)
    indices, weights = _local_samples(keys[:, 1], m, w_site, assign,
                                      center_idx, t_i,
                                      _windowed_sum(local_costs), k, t,
                                      t_buffer)
    return Selection(indices=indices, weights=weights, t_i=t_i,
                     local_costs=local_costs)


def _local_solves(keys, embeddings, w_site, k: int, lloyd_iters: int, b):
    """Every site's k-means solve at once (one launch per seeding or Lloyd
    step): the sampling masses ``m`` (S, M), the assignment (S, M) and the
    nearest real example of each centre (S, k) int32."""
    obj = objective_mod.get_objective("kmeans")
    centers = clustering._kmeans_pp_init(keys, embeddings, w_site, k, obj, b)
    centers, _ = clustering._lloyd(embeddings, centers, w_site, lloyd_iters,
                                   obj, b)
    d2, assign = b.min_dist_argmin(embeddings, centers)
    # nearest real example per center (masked argmin over the column)
    dc = clustering.pairwise_sq_dists(centers, embeddings,
                                      device=embeddings.device)
    dc = torch.where(w_site[:, None, :] > 0, dc, torch.inf)
    return w_site * d2, assign, dc.argmin(-1).to(torch.int32)


def _local_samples(keys, m, w_site, assign, center_idx, t_i, total_m,
                   k: int, t: int, t_buffer: int):
    """Every site's ``t_buffer`` draws ~ m, their weights (0 past ``t_i``)
    and the centre examples' residual weights: (indices, weights), each
    (S, t_buffer + k)."""
    idx = weighted_choice(keys, m, t_buffer)                 # (S, t_buffer)
    slots = torch.arange(t_buffer, device=m.device)
    valid = (slots[None, :] < t_i[:, None]) & (total_m > _TINY)
    m_q = m.gather(1, idx)
    w_s = torch.where(valid & (m_q > _TINY),
                      total_m * w_site.gather(1, idx)
                      / (float(t) * torch.clamp_min(m_q, _TINY)),
                      0.0)
    # cluster masses as one-hot sums (a fixed order on every device)
    oh = torch.nn.functional.one_hot(assign.long(), k).to(torch.float32)
    w_pb = (w_site[..., None] * oh).sum(-2)
    oh_s = torch.nn.functional.one_hot(assign.gather(1, idx).long(),
                                       k).to(torch.float32)
    w_sb = (w_s[..., None] * oh_s).sum(-2)
    return (torch.cat([idx.to(torch.int32), center_idx], dim=1),
            torch.cat([w_s, w_pb - w_sb], dim=1))


def gather_selected(site_tokens, sel: Selection
                    ) -> Dict[str, torch.Tensor]:
    """site_tokens (n_sites, M, L) -> selected tokens + weights, flattened
    over sites: {"tokens": (n_sites*(t_buffer+k), L), "weights": (...)},
    on the selection's device."""
    dev = sel.indices.device
    site_tokens = as_tensor(site_tokens, dev)
    rows = torch.arange(site_tokens.shape[0], device=dev)[:, None]
    toks = site_tokens[rows, sel.indices.long()]
    return {"tokens": toks.reshape(-1, site_tokens.shape[-1]),
            "weights": sel.weights.reshape(-1)}
