"""Vocabulary embedding + LM head, with an optional OrbitCache-style
hot-row cache (port of ``repro.models.embedding``).

The vocabulary table is a KV store with Zipf-skewed keys (token ids).
``HotCache`` holds the C most popular rows, chosen by the same top-k
rule as the switch cache's controller; ``embed_hot`` serves the cached ids
from it and the rest from the table.  The serving path itself calls
``embed``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.parallel.sharding import with_sharding

from .layers import Init


class HotCache(NamedTuple):
    ids: torch.Tensor      # int32[C] sorted hot token ids (-1 pad at the end)
    rows: torch.Tensor     # [C, d] rows of the cached ids
    version: torch.Tensor  # int32[] bumped by the controller on refresh


class Embedding(nn.Module):
    """``table [vocab, d]`` (normal x d**-0.5) and, unless tied, ``head
    [vocab, d]`` (normal x 0.02)."""

    def __init__(self, init: Init, vocab: int, d: int, dtype,
                 tie: bool = False):
        super().__init__()
        self.table = init.normal((vocab, d), d ** -0.5, dtype)
        if not tie:
            self.head = init.normal((vocab, d), 0.02, dtype)


def embed(tokens: torch.Tensor, p, ctx=None) -> torch.Tensor:
    """tokens [B,S] -> [B,S,d].  With ``ctx`` the table is vocab-sharded
    and the rows come back batch-sharded.  ``F.embedding`` is the
    reference's ``table[tokens]`` gather; its backward is one DTensor can
    shard (``table[tokens]``'s accumulating ``index_put`` is not)."""
    rows = F.embedding(tokens, p.table)
    return with_sharding(ctx, rows, "batch", None, None)


def embed_hot(tokens: torch.Tensor, p, hot: HotCache,
              ctx=None) -> torch.Tensor:
    """Hot-cache lookup: cached rows for cached ids, the table for the
    rest."""
    c = hot.ids.shape[0]
    slot = torch.searchsorted(hot.ids, tokens.to(hot.ids.dtype))
    slot = slot.clamp(0, c - 1)
    is_hot = hot.ids[slot] == tokens
    hot_rows = hot.rows[slot]
    cold_rows = embed(torch.where(is_hot, 0, tokens), p, ctx)
    return torch.where(is_hot[..., None], hot_rows, cold_rows)


def logits(x: torch.Tensor, p, ctx=None, tie: bool = False) -> torch.Tensor:
    """x [B,S,d] -> [B,S,V] (vocab-sharded on the model axis with
    ``ctx``)."""
    w = p.table if tie or not hasattr(p, "head") else p.head
    out = torch.einsum("bsd,vd->bsv", x, w)
    return with_sharding(ctx, out, "batch", None, "vocab")


def refresh_hot_cache(p, counts: torch.Tensor, size: int) -> HotCache:
    """Controller step: pick the ``size`` most frequent token ids from the
    observed counts (CMS estimates or exact; ties to the lower id) and
    snapshot their rows."""
    top = torch.argsort(-counts, stable=True)[:size]
    ids = torch.sort(top).values.to(torch.int32)
    rows = p.table[ids]
    return HotCache(ids=ids, rows=rows,
                    version=torch.zeros((), dtype=torch.int32,
                                        device=ids.device))
