"""Server popularity-tracker state (port of the types of
``repro.core.sketch``).

Only the state is ported: every ``ServerState`` carries a tracker, also
when popularity tracking is off (the rack's main path).  The tracking
itself, ``track_fused`` through the count-min kernel, belongs to the
control-plane slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.types import resolve_device

CMS_DEPTH = 5  # five hash functions, as in the paper


class CountMinSketch(NamedTuple):
    counts: torch.Tensor  # int32[CMS_DEPTH, width]

    @property
    def width(self) -> int:
        return self.counts.shape[1]


class CandidateSet(NamedTuple):
    kidx: torch.Tensor  # int32[k_cand], -1 = empty
    est: torch.Tensor   # int32[k_cand]


class PopularityTracker(NamedTuple):
    cms: CountMinSketch
    cand: CandidateSet


def init_tracker(width: int, k_cand: int, lead: tuple[int, ...] = (),
                 device=None) -> PopularityTracker:
    """An empty tracker; ``lead`` prepends batch axes (one per server)."""
    d = resolve_device(device)
    return PopularityTracker(
        cms=CountMinSketch(torch.zeros(lead + (CMS_DEPTH, width),
                                       dtype=torch.int32, device=d)),
        cand=CandidateSet(
            kidx=torch.full(lead + (k_cand,), -1, dtype=torch.int32, device=d),
            est=torch.zeros(lead + (k_cand,), dtype=torch.int32, device=d)),
    )
