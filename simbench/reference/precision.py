"""The float32 sites of the window that a lower precision would move.

The reference computes them as the port does.  The benchmark's control
(``simbench/control.py``) sets :data:`LOW` to ``torch.bfloat16``, the
nearest precision below float32, and so computes the rack's clock, the
serve times and latencies, their ``log2`` bucket and the recirculation
budget in it.
"""
from __future__ import annotations

import torch

LOW: torch.dtype | None = None


def site(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the site computes it: itself, or cast to :data:`LOW`."""
    return x if LOW is None else x.to(LOW)


def log2_dtype() -> torch.dtype:
    """The dtype of ``lat_bucket``'s ``log2``: float64, rounded once to
    float32, or :data:`LOW`."""
    return torch.float64 if LOW is None else LOW
