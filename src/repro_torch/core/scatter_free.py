"""Single-writer register updates (port of ``repro.core.scatter_free``).

The reference builds a bool[B, N] membership matrix and reduces it; on a
GPU a masked scatter does the same job directly.  Both return the
reference's ``(writer, written)``: ``writer`` is 0 where nothing wrote,
as ``argmax`` over an all-false column gives.
"""
from __future__ import annotations

import torch


def unique_writer(dest: torch.Tensor, mask: torch.Tensor, size: int,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(writer int64[size], written bool[size]) for distinct destinations.

    Each masked lane targets a distinct destination (values outside
    ``[0, size)`` are dropped), so a plain scatter finds the one writer.
    """
    return last_writer(dest, mask, size)


def last_writer(dest: torch.Tensor, mask: torch.Tensor, size: int,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(writer int64[size], written bool[size]); the LAST masked lane
    targeting a destination wins."""
    ok = mask & (dest >= 0) & (dest < size)
    lanes = torch.arange(dest.shape[0], dtype=torch.int64, device=dest.device)
    # masked-out lanes write the sentinel -1 into a spare column
    tgt = torch.where(ok, dest.to(torch.int64), size)
    lanes = torch.where(ok, lanes, -1)
    w = torch.full((size + 1,), -1, dtype=torch.int64, device=dest.device)
    w = w.scatter_reduce(0, tgt, lanes, reduce="amax")[:size]
    written = w >= 0
    return torch.where(written, w, 0), written


def set_drop(arr: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """The reference's ``arr.at[idx].set(vals, mode='drop')`` along dim 0.

    A negative index counts from the end, as XLA normalises it; an index
    still outside ``[0, n)`` is dropped; of repeated indices the last
    wins, the order XLA applies the updates in on the CPU.  ``vals`` is a
    scalar or one row per index.
    """
    n = arr.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    writer, written = last_writer(idx, torch.ones_like(idx, dtype=torch.bool),
                                  n)
    vals = torch.as_tensor(vals, dtype=arr.dtype, device=arr.device)
    if vals.dim():
        vals = vals.expand(idx.shape + arr.shape[1:])[writer]
    return torch.where(written.reshape((n,) + (1,) * (arr.dim() - 1)),
                       vals, arr)
