"""MoE routing compared between two runs of one model (JAX-free, so the
CUDA tests can use it): where a router's top-k set may differ, and which
positions are held."""
import numpy as np


def rows_before_first_flip(probs, idx_a, idx_b, top_k, near_tie):
    """Per layer, ``probs`` (B, L, E) of run a and the top-k experts
    ``idx_a``, ``idx_b`` (B, L, K) of both runs. A top-k set (the order
    inside it moves no capacity slot) may differ only at a near tie -- run
    a's gap between the k-th and the next probability below ``near_tie``
    -- or at or after a position of its row that differed before (a
    capacity slot is a cumulative count over the row, attention is causal).
    Returns the (B, L) mask of each row's positions before its first
    difference."""
    B, L = np.asarray(idx_a[0]).shape[:2]
    first = np.full(B, L)
    for p, a, b in zip(probs, idx_a, idx_b):
        top = -np.sort(-np.asarray(p), axis=-1)
        gap = top[..., top_k - 1] - top[..., top_k]
        flips = (np.sort(np.asarray(a), -1)
                 != np.sort(np.asarray(b), -1)).any(axis=-1)
        for row, pos in np.argwhere(flips):
            assert pos >= first[row] or gap[row, pos] < near_tie, (
                row, pos, gap[row, pos])
            first[row] = min(first[row], pos)
    return np.arange(L)[None] < first[:, None]
