"""Deterministic synthetic data pipeline (port of
``repro.training.data``).

Token streams are (a) reproducible from ``(seed, step, shard)`` alone --
the property exact restart relies on -- and (b) learnable: tokens follow
an order-1 Markov chain with Zipfian marginals, so a model's loss
decreases.

The reference draws its uniforms with ``jax.random``, which the port does
not reproduce (the RNG seam).  A batch is therefore two parts: the native
draw (:meth:`SyntheticStream.uniform`, ``torch.rand`` from a
``torch.Generator`` seeded from ``(seed, step, shard)`` alone, on the
stream's device) and the deterministic remainder
(:func:`tokens_from_uniform`), which equals the reference's given the same
uniforms.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.types import resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1
    markov_jump: int = 7     # next ~ (cur * jump + noise) mod V


def zipf_cdf(cfg: DataConfig) -> np.ndarray:
    """The Zipf CDF over the vocabulary, built in float64 and rounded
    once to float32, as the reference builds it."""
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    w = ranks ** -cfg.zipf_alpha
    return np.cumsum(w / w.sum()).astype(np.float32)


def draw_seed(seed: int, step: int, shard: int) -> int:
    """A generator seed that depends on ``(seed, step, shard)`` only."""
    ss = np.random.SeedSequence([seed, step, shard])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def tokens_from_uniform(u: torch.Tensor, cfg: DataConfig,
                        cdf: torch.Tensor | None = None) -> dict:
    """The batch for uniforms ``u`` [b, seq_len] (float32 in [0, 1)):
    Zipf ranks by a left ``searchsorted`` over the float32 CDF at even
    positions, odd positions the Markov successor of the token before,
    labels the tokens shifted left (0 at the end)."""
    if cdf is None:
        cdf = torch.from_numpy(zipf_cdf(cfg)).to(u.device)
    b = u.shape[0]
    base = torch.searchsorted(cdf, u).to(torch.int32)
    nxt = (base * cfg.markov_jump + 1) % cfg.vocab_size
    even = torch.arange(cfg.seq_len, device=u.device)[None, :] % 2 == 0
    toks = torch.where(even, base, torch.roll(nxt, 1, dims=1))
    labels = torch.cat(
        [toks[:, 1:], torch.zeros((b, 1), dtype=torch.int32,
                                  device=u.device)], dim=1)
    return {"tokens": toks, "labels": labels}


class SyntheticStream:
    """Stateless batch generator: ``batch(step)`` is pure in ``(cfg,
    step)``.  Batches live on ``device`` (the CUDA card unless ``"cpu"``
    is given)."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._cdf = torch.from_numpy(zipf_cdf(cfg)).to(self.device)

    def uniform(self, step: int, num_shards: int = 1,
                shard: int = 0) -> torch.Tensor:
        """The native draw: float32 uniforms [global_batch / num_shards,
        seq_len]."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(
            draw_seed(cfg.seed, step, shard))
        return torch.rand((cfg.global_batch // num_shards, cfg.seq_len),
                          generator=gen, dtype=torch.float32,
                          device=self.device)

    def batch(self, step: int, num_shards: int = 1, shard: int = 0) -> dict:
        return tokens_from_uniform(self.uniform(step, num_shards, shard),
                                   self.cfg, self._cdf)
