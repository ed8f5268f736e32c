"""Cache lookup (port of ``repro.core.lookup``, paper §3.1): the 128-bit
key hash against the ``C`` installed entries.

The match-action table is an exact match over every installed entry.
The data plane's hot path does this match inside the fused
``kernels.subround`` pass (``core/pipeline.py``); :func:`lookup` is the
standalone form that the distributed ring runs and that tests compose the
seed switch step from, and :func:`install` / :func:`evict` are the
controller's writes.
"""
from __future__ import annotations

import torch

from .scatter_free import set_drop
from .types import LookupTable

I32 = torch.int32


def lookup(table: LookupTable, hkey: torch.Tensor) -> torch.Tensor:
    """int32[B] CacheIdx of each hash (int32[B, 4] bit patterns), or -1 on
    a miss; of several matching entries the first wins."""
    eq = torch.all(hkey[:, None, :] == table.hkeys[None, :, :], dim=-1)
    eq = eq & table.occupied[None, :]
    hit = torch.any(eq, dim=-1)
    cidx = torch.argmax(eq.to(I32), dim=-1).to(I32)
    return torch.where(hit, cidx, -1).to(I32)


def install(table: LookupTable, cidx: torch.Tensor, hkey: torch.Tensor,
            kidx: torch.Tensor) -> LookupTable:
    """Install entry ``cidx`` <- key (controller side; vectorised over
    ``cidx``)."""
    return LookupTable(
        hkeys=set_drop(table.hkeys, cidx, hkey),
        occupied=set_drop(table.occupied, cidx, True),
        kidx=set_drop(table.kidx, cidx, kidx),
    )


def evict(table: LookupTable, cidx: torch.Tensor) -> LookupTable:
    """Remove entry ``cidx`` (controller side)."""
    return LookupTable(
        hkeys=set_drop(table.hkeys, cidx, 0),
        occupied=set_drop(table.occupied, cidx, False),
        kidx=set_drop(table.kidx, cidx, -1),
    )
