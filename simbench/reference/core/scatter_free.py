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


