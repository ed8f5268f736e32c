"""The serving grid of one subround (the port's ``core/orbit.py``,
``ServeGrid`` alone)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class ServeGrid(NamedTuple):
    """Requests served by orbit lines this pass: dense [C, J] grid."""

    served: torch.Tensor   # bool[C, J]
    client: torch.Tensor   # int32[C, J]
    seq: torch.Tensor      # int32[C, J]
    port: torch.Tensor     # int32[C, J]
    ts: torch.Tensor       # float32[C, J] request submit time
    order: torch.Tensor    # int32[C, J] serve order within window
    req_kidx: torch.Tensor # int32[C, J] key each request asked for
    kidx: torch.Tensor     # int32[C]  key carried by the serving line
    vlen: torch.Tensor     # int32[C]  total value bytes for the entry
    version: torch.Tensor  # int32[C]
