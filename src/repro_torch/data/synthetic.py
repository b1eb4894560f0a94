"""Deterministic synthetic data (the port of ``repro.data.synthetic``).

* :class:`BigramLM` -- token streams from a fixed random bigram chain over a
  restricted vocabulary slice: a learnable distribution, so the training
  examples show real loss reduction. It draws with
  :mod:`repro_torch.core.prng`, the JAX package's ``jax.random`` draws.
* ``paper_dataset``, ``drifting_mixture_stream`` and
  ``contaminated_stream`` (numpy only) are bit-equal to the JAX package's
  for the same seed.

:func:`paper_dataset` makes Gaussian-mixture stand-ins shape-matched to the
paper's evaluation datasets (the UCI files are unavailable offline; see
DESIGN.md Sec. 7). The ``synthetic`` entry *is* the paper's own synthetic
setup: k=5 centers ~ N(0, I_10), 20k points per center.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple, Union

import numpy as np
import torch

from repro_torch.core import prng

# elements of the (steps, batch, active_vocab) Gumbel block that one pass
# of BigramLM.batch draws at a time
_GUMBEL_CHUNK = 2 ** 22


@dataclasses.dataclass
class BigramLM:
    """Fixed random bigram transition matrix over ``active_vocab`` ids, on
    ``device`` (CUDA unless the caller asks for the CPU)."""

    vocab_size: int
    active_vocab: int = 256
    seed: int = 0
    temperature: float = 0.7
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        from repro_torch.core.backend import resolve_device
        self.device = resolve_device(self.device)
        self.active_vocab = min(self.active_vocab, self.vocab_size)
        key = prng.PRNGKey(self.seed, device=self.device)
        self._logits = (prng.normal(key, (self.active_vocab,
                                          self.active_vocab))
                        / self.temperature)

    def batch(self, step: int, batch_size: int, seq_len: int
              ) -> Dict[str, torch.Tensor]:
        """Returns {"tokens": (B, L) i32, "labels": (B, L) i32}; labels are
        the next-token targets. The key is the JAX package's, a hash of
        ``("bigram", seed, step)``: Python salts the hash of a string per
        process (PYTHONHASHSEED), so within one process the port draws the
        JAX package's batches, and another process draws others."""
        key = prng.PRNGKey(hash(("bigram", self.seed, step)) % (2**31),
                           device=self.device)
        k0, k1 = prng.split(key, 2)
        first = prng.randint(k0, (batch_size,), 0, self.active_vocab)
        keys = prng.split(k1, seq_len)
        # each step is jax.random.categorical under its own key: the argmax
        # of Gumbel noise of the (B, active_vocab) logits' shape plus them
        per = max(1, _GUMBEL_CHUNK // max(1, batch_size * self.active_vocab))
        seq, tok = [first.long()], first.long()
        for s in range(0, seq_len, per):
            noise = prng.gumbel(keys[s:s + per],
                                (batch_size, self.active_vocab))
            for g in noise:
                tok = torch.argmax(g + self._logits[tok], dim=-1)
                seq.append(tok)
        seq = torch.stack(seq, dim=0).T.to(torch.int32)   # (B, L+1)
        return {"tokens": seq[:, :-1].contiguous(),
                "labels": seq[:, 1:].contiguous()}

_PAPER_SHAPES = {
    # name: (n_points, dim, k, n_true_clusters, noise)
    "synthetic": (100_000, 10, 5, 5, 1.0),
    "spam": (4_601, 58, 10, 12, 0.6),
    "pendigits": (10_992, 16, 10, 10, 0.5),
    "letter": (20_000, 16, 10, 26, 0.7),
    "colorhistogram": (68_040, 32, 10, 14, 0.5),
    "yearpredictionmsd": (515_345, 90, 50, 60, 0.8),
}


def paper_dataset(name: str, seed: int = 0, scale: float = 1.0
                  ) -> Tuple[np.ndarray, int]:
    """Gaussian-mixture stand-in matched to the paper dataset's (n, d, k).
    ``scale`` < 1 subsamples n for CI-speed runs. Returns (points, k)."""
    n, d, k, n_clusters, noise = _PAPER_SHAPES[name]
    # subsampling floor: below ~5k points the k=10..50 instances degenerate
    n = max(int(n * scale), min(n, 5000), n_clusters * 10)
    rng = np.random.default_rng(seed)
    if name == "synthetic":
        centers = rng.standard_normal((5, 10))
        per = n // 5
        pts = np.concatenate([
            c + rng.standard_normal((per, 10)) for c in centers])
        return pts.astype(np.float32), k
    centers = rng.standard_normal((n_clusters, d)) * 3.0
    weights = rng.dirichlet(np.ones(n_clusters) * 2.0)
    counts = rng.multinomial(n, weights)
    parts = []
    for c, cnt in zip(centers, counts):
        cov_scale = noise * (0.5 + rng.random())
        parts.append(c + cov_scale * rng.standard_normal((cnt, d)))
    pts = np.concatenate(parts)
    # a few far outliers, as in real UCI tables
    n_out = max(n // 1000, 1)
    pts[:n_out] += rng.standard_normal((n_out, d)) * 20.0
    rng.shuffle(pts)
    return pts.astype(np.float32), k


def paper_dataset_names():
    return list(_PAPER_SHAPES)


def drifting_mixture_stream(
    n_batches: int,
    batch_size: int,
    d: int = 10,
    k: int = 5,
    drift: float = 0.05,
    sigma: float = 0.3,
    seed: int = 0,
) -> Iterator[np.ndarray]:
    """Non-stationary Gaussian-mixture stream for the streaming subsystem:
    the ``k`` mixture centers random-walk by ``drift * N(0, I)`` per batch
    and the mixture weights are re-drawn every batch, so no fixed prefix is
    representative of the whole stream -- exactly the regime merge-and-reduce
    summaries must survive. Deterministic in ``seed``; yields ``n_batches``
    arrays of shape (batch_size, d) float32."""
    rng = np.random.default_rng(seed)
    centers = 3.0 * rng.standard_normal((k, d))
    for _ in range(n_batches):
        probs = rng.dirichlet(np.ones(k) * 2.0)
        comp = rng.choice(k, size=batch_size, p=probs)
        pts = centers[comp] + sigma * rng.standard_normal((batch_size, d))
        yield pts.astype(np.float32)
        centers = centers + drift * rng.standard_normal((k, d))


def contaminated_stream(
    n_batches: int,
    batch_size: int,
    d: int = 10,
    k: int = 5,
    drift: float = 0.05,
    sigma: float = 0.3,
    outlier_frac: float = 0.02,
    outlier_scale: float = 25.0,
    burst_every: int = 0,
    seed: int = 0,
) -> Iterator[np.ndarray]:
    """Adversarially contaminated drifting stream (outliers-workload
    groundwork): each :func:`drifting_mixture_stream` batch has a seeded
    ``outlier_frac`` fraction of its points replaced by far-field outliers
    at radius ~``outlier_scale`` in uniformly random directions -- the
    contamination model under which the paper's k-median objective is the
    robust choice. With ``burst_every > 0``, every ``burst_every``-th
    batch is *fully* adversarial (all points outliers), simulating a
    compromised or faulty site feeding garbage between aggregation rounds
    -- the stream-under-faults scenario the WAN runtime tests exercise.
    Deterministic in ``seed`` (contamination draws are independent of the
    base stream's, so the clean and contaminated streams share their
    inlier points batch for batch)."""
    if not 0.0 <= outlier_frac <= 1.0:
        raise ValueError(f"outlier_frac must be in [0, 1], got "
                         f"{outlier_frac}")
    rng = np.random.default_rng((seed, 0xB4D))
    base = drifting_mixture_stream(n_batches, batch_size, d=d, k=k,
                                   drift=drift, sigma=sigma, seed=seed)
    for b, pts in enumerate(base):
        full_burst = burst_every > 0 and (b + 1) % burst_every == 0
        n_out = batch_size if full_burst else int(
            round(outlier_frac * batch_size))
        if n_out:
            idx = rng.choice(batch_size, size=n_out, replace=False)
            dirs = rng.standard_normal((n_out, d))
            dirs /= np.maximum(np.linalg.norm(dirs, axis=1, keepdims=True),
                               1e-12)
            radii = outlier_scale * (1.0 + rng.random((n_out, 1)))
            pts = pts.copy()
            pts[idx] = (dirs * radii).astype(np.float32)
        yield pts
