"""Serving (the port of ``repro.serve.engine``): prefill + decode steps and
a slot-based batched engine.

``make_serve_steps(cfg, max_len)`` builds the two step functions:

  * ``prefill_step(params, tokens)            -> (last_logits, cache)``
  * ``decode_step(params, token, pos, cache)  -> (logits, cache)``

``Engine`` adds continuous-batching-lite on top: a fixed number of slots,
each with its own sequence; finished sequences free their slot for the next
request. The port's caches are per-layer tensors that ``forward`` writes
in place (the JAX package returns new ones), so the engine owns one
batched cache and writes each prefilled request into its slot.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch import tree as tree_mod
from repro_torch.core import prng
from repro_torch.models import (cache_spec, forward, init_cache,
                                make_positions)
from repro_torch.models.config import ModelConfig


def _device(params) -> torch.device:
    return params["embed"]["table"].device


def make_serve_steps(cfg: ModelConfig, max_len: int):
    def prefill_step(params, tokens):
        B, L = tokens.shape
        cache = init_cache(cfg, B, max_len, tokens.device)
        pos = make_positions(tokens, cfg)
        with torch.inference_mode():
            logits, cache, _ = forward(params, tokens, pos, cfg, cache=cache)
        return logits[:, -1], cache

    def decode_step(params, token, pos_scalar, cache):
        """token (B, 1); pos_scalar the current position of the new token;
        ``cache`` is written in place."""
        pos = make_positions(token, cfg, offset=pos_scalar)
        with torch.inference_mode():
            logits, cache, _ = forward(params, token, pos, cfg, cache=cache)
        return logits[:, 0], cache

    return prefill_step, decode_step


def sample_token(key: torch.Tensor, logits: torch.Tensor,
                 temperature: float = 0.0,
                 vocab_size: Optional[int] = None) -> torch.Tensor:
    """Greedy (``temperature <= 0``) or ``jax.random.categorical`` under one
    key: Gumbel noise of the logits' whole (B, V) shape, then the argmax."""
    if vocab_size is not None and logits.shape[-1] != vocab_size:
        pad = torch.arange(logits.shape[-1], device=logits.device) \
            >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / temperature
    noise = prng.gumbel(key.to(logits.device), tuple(scaled.shape))
    return torch.argmax(noise + scaled, dim=-1).to(torch.int32)


def generate(
    params,
    cfg: ModelConfig,
    prompt: torch.Tensor,        # (B, Lp)
    n_new: int,
    temperature: float = 0.0,
    key: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Greedy/temperature generation on the params' device; returns
    (B, Lp + n_new) int32."""
    dev = _device(params)
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
    B, Lp = prompt.shape
    max_len = Lp + n_new
    prefill, decode = make_serve_steps(cfg, max_len)
    key = key.to(dev) if key is not None else prng.PRNGKey(0, device=dev)

    logits, cache = prefill(params, prompt)
    toks = [prompt]
    tok = sample_token(key, logits, temperature, cfg.vocab_size)[:, None]
    for t in range(n_new - 1):
        toks.append(tok)
        key, kt = prng.split(key, 2)
        logits, cache = decode(params, tok, Lp + t, cache)
        tok = sample_token(kt, logits, temperature, cfg.vocab_size)[:, None]
    toks.append(tok)
    return torch.cat(toks, dim=1)


@dataclasses.dataclass
class Request:
    prompt: np.ndarray
    max_new: int
    out: Optional[np.ndarray] = None


def _batch_axes(cfg: ModelConfig, max_len: int) -> List[int]:
    """Each cache leaf's batch axis, in flattening order: the axis where a
    cache of two sequences and one of one differ in shape."""
    two = tree_mod.leaves(cache_spec(cfg, 2, max_len))
    one = tree_mod.leaves(cache_spec(cfg, 1, max_len))
    axes = []
    for a, b in zip(two, one):
        diff = [i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                if x != y]
        if len(diff) != 1:
            raise ValueError(f"a cache leaf of shape {tuple(a.shape)} has "
                             f"no single batch axis")
        axes.append(diff[0])
    return axes


class Engine:
    """Slot-based batched decoding: all slots decode in lockstep (one
    forward per step for the whole batch); each slot tracks its own
    absolute position via per-slot position ids."""

    def __init__(self, params, cfg: ModelConfig, n_slots: int = 4,
                 max_len: int = 512):
        self.params, self.cfg = params, cfg
        self.n_slots, self.max_len = n_slots, max_len
        self.device = _device(params)
        self.cache = init_cache(cfg, n_slots, max_len, self.device)
        self._axes = _batch_axes(cfg, max_len)
        self.positions = np.zeros(n_slots, np.int64)
        self.active: List[Optional[Request]] = [None] * n_slots
        self.tokens = np.zeros((n_slots, 1), np.int32)

    def _decode(self, token, positions):
        # per-slot positions: (B,) -> (B, 1) position ids
        B = token.shape[0]
        pos = positions.to(torch.int32)[:, None]
        if self.cfg.mrope_sections is not None:
            pos = pos[:, None, :].expand(B, 3, 1)
        with torch.inference_mode():
            logits, _, _ = forward(self.params, token, pos, self.cfg,
                                   cache=self.cache)
        return logits[:, 0]

    def _prefill_one(self, tokens):
        # single-request prefill into a fresh single-slot cache
        cache = init_cache(self.cfg, 1, self.max_len, self.device)
        pos = make_positions(tokens, self.cfg)
        with torch.inference_mode():
            logits, cache, _ = forward(self.params, tokens, pos, self.cfg,
                                       cache=cache)
        return logits[:, -1], cache

    def _merge_slot(self, one, s: int) -> None:
        """Write a one-sequence cache into slot ``s`` of the batched cache,
        each leaf along its own batch axis."""
        for full, leaf, axis in zip(tree_mod.leaves(self.cache),
                                    tree_mod.leaves(one), self._axes):
            full.narrow(axis, s, 1).copy_(leaf)

    def submit(self, req: Request) -> bool:
        for s in range(self.n_slots):
            if self.active[s] is None:
                logits, c1 = self._prefill_one(torch.as_tensor(
                    np.asarray(req.prompt)[None], device=self.device))
                self._merge_slot(c1, s)
                self.active[s] = req
                req.out = req.prompt.copy()
                self.tokens[s, 0] = int(torch.argmax(logits[0]))
                self.positions[s] = len(req.prompt)
                return True
        return False

    def step(self):
        logits = self._decode(torch.as_tensor(self.tokens, device=self.device),
                              torch.as_tensor(self.positions,
                                              device=self.device))
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        for s, req in enumerate(self.active):
            if req is None:
                continue
            req.out = np.concatenate([req.out, self.tokens[s]])
            self.tokens[s, 0] = nxt[s]
            self.positions[s] += 1
            if len(req.out) - len(req.prompt) >= req.max_new:
                self.active[s] = None

    def run(self, requests: List[Request]) -> List[Request]:
        pending = list(requests)
        done: List[Request] = []
        while pending or any(r is not None for r in self.active):
            while pending and self.submit(pending[0]):
                done.append(pending.pop(0))
            self.step()
        return done
