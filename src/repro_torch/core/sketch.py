"""Count-min sketch + heavy-hitter candidates (port of
``repro.core.sketch``, paper §3.8).

Storage servers track the popularity of uncached keys with a count-min
sketch of five hash functions and a fixed-size candidate table, and report
their top-k keys to the controller every period; the tracker then resets.

The batched functions (:func:`track_fused`, :func:`merge_candidates_hashed`,
:func:`report_and_reset`) take an optional leading axis of trackers, one
per server, where the reference ``vmap``s them: every server's sketch then
updates in one count-min kernel launch.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.hashing import fold_hash, hash128_u32, to_u32
from repro_torch.core.scatter_free import last_writer
from repro_torch.core.types import resolve_device

CMS_DEPTH = 5  # five hash functions, as in the paper
I32 = torch.int32


class CountMinSketch(NamedTuple):
    counts: torch.Tensor  # int32[..., CMS_DEPTH, width]

    @property
    def width(self) -> int:
        return self.counts.shape[-1]


class CandidateSet(NamedTuple):
    kidx: torch.Tensor  # int32[..., k_cand], -1 = empty
    est: torch.Tensor   # int32[..., k_cand]


class PopularityTracker(NamedTuple):
    cms: CountMinSketch
    cand: CandidateSet


def init_tracker(width: int, k_cand: int, lead: tuple[int, ...] = (),
                 device=None) -> PopularityTracker:
    """An empty tracker; ``lead`` prepends batch axes (one per server)."""
    d = resolve_device(device)
    return PopularityTracker(
        cms=CountMinSketch(torch.zeros(lead + (CMS_DEPTH, width),
                                       dtype=I32, device=d)),
        cand=CandidateSet(
            kidx=torch.full(lead + (k_cand,), -1, dtype=I32, device=d),
            est=torch.zeros(lead + (k_cand,), dtype=I32, device=d)),
    )


def _rows(hkey: torch.Tensor, width: int) -> torch.Tensor:
    """Per-depth columns for a batch of hashes: int32[B, CMS_DEPTH]."""
    return torch.stack([fold_hash(hkey, width, salt=d)
                        for d in range(CMS_DEPTH)], dim=-1)


def cms_update(cms: CountMinSketch, hkey: torch.Tensor, mask: torch.Tensor,
               ) -> CountMinSketch:
    """Increment all five rows for each masked key (one sketch)."""
    w = cms.width
    cells = _rows(hkey, w).long() + torch.arange(CMS_DEPTH,
                                                 device=hkey.device) * w
    counts = cms.counts.reshape(-1).index_add(
        0, cells.reshape(-1),
        mask[:, None].expand(-1, CMS_DEPTH).reshape(-1).to(I32))
    return CountMinSketch(counts.reshape(cms.counts.shape))


def cms_query(cms: CountMinSketch, hkey: torch.Tensor) -> torch.Tensor:
    """Point estimate: min over the five rows.  int32[B]."""
    idx = _rows(hkey, cms.width).long()
    per_depth = torch.stack([cms.counts[d, idx[:, d]]
                             for d in range(CMS_DEPTH)], dim=-1)
    return per_depth.amin(dim=-1)


def _lexsort(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((secondary, primary))``: ascending by ``primary``,
    ties by ``secondary``, then by position (two stable sorts)."""
    o = torch.argsort(secondary, stable=True)
    return o[torch.argsort(primary[o], stable=True)]


def merge_candidates(cand: CandidateSet, kidx: torch.Tensor,
                     est: torch.Tensor, mask: torch.Tensor) -> CandidateSet:
    """Keep the best ``k_cand`` distinct keys of (candidates U batch),
    exactly (one tracker)."""
    k_cand = cand.kidx.shape[0]
    all_k = torch.cat([cand.kidx, torch.where(mask, kidx, -1)])
    all_e = torch.cat([cand.est, torch.where(mask, est, 0)])
    # (kidx asc, est desc): the first occurrence of a key has its best
    # estimate; repeats are dropped
    order = _lexsort(all_k, -all_e)
    sk, se = all_k[order], all_e[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=sk.device),
                       sk[1:] != sk[:-1]])
    ok = first & (sk >= 0)
    se = torch.where(ok, se, -1)
    sk = torch.where(ok, sk, -1)
    top = torch.argsort(-se, stable=True)[:k_cand]
    return CandidateSet(kidx=sk[top],
                        est=torch.where(se[top] < 0, 0, se[top]))


def merge_candidates_hashed(cand: CandidateSet, kidx: torch.Tensor,
                            est: torch.Tensor, mask: torch.Tensor,
                            ) -> CandidateSet:
    """O(B) hashed candidate maintenance (the data-plane path).

    Each key owns a hash slot and claims it when its estimate beats the
    occupant's.  When several winning lanes claim one slot in a batch, the
    last lane wins, as the reference's scatter does.  ``cand`` may carry a
    leading tracker axis, with ``est`` and ``mask`` [..., B] over the
    shared ``kidx[B]``.
    """
    n = cand.kidx.shape[-1]
    lead = tuple(cand.kidx.shape[:-1])
    s = math.prod(lead)
    b = kidx.shape[-1]
    dev = kidx.device
    slot = (to_u32(hash128_u32(kidx)[..., 0]) % n).to(torch.int64)
    slot = torch.where(mask, slot.expand(lead + (b,)), n).reshape(s, b)
    # one flat table of s * (n + 1) cells: column n of each tracker is the
    # spare cell that masked lanes write into
    base = torch.arange(s, device=dev)[:, None] * (n + 1)
    spare = torch.full(lead + (1,), torch.iinfo(I32).min, dtype=I32,
                       device=dev)
    best = torch.cat([cand.est, spare], dim=-1).reshape(-1).scatter_reduce(
        0, (base + slot).reshape(-1), est.reshape(-1),
        reduce="amax", include_self=True).reshape(s, n + 1)[:, :n]
    own = torch.gather(best, 1, slot.clamp(max=n - 1))
    won = mask.reshape(s, b) & (est.reshape(s, b) >= own) & (slot < n)
    base_n = torch.arange(s, device=dev)[:, None] * n
    writer, written = last_writer((base_n + slot).reshape(-1),
                                  won.reshape(-1), s * n)
    lane_kidx = kidx.expand(lead + (b,)).reshape(-1)
    new_kidx = torch.where(written, lane_kidx[writer],
                           cand.kidx.reshape(-1))
    return CandidateSet(kidx=new_kidx.reshape(cand.kidx.shape),
                        est=best.reshape(cand.est.shape))


def track(tr: PopularityTracker, kidx: torch.Tensor, mask: torch.Tensor,
          exact: bool = False) -> PopularityTracker:
    """One batch of arrivals at a server: CMS update + candidate merge."""
    hkey = hash128_u32(kidx)
    cms = cms_update(tr.cms, hkey, mask)
    est = cms_query(cms, hkey)
    merge = merge_candidates if exact else merge_candidates_hashed
    return PopularityTracker(cms, merge(tr.cand, kidx, est, mask))


def track_fused(tr: PopularityTracker, kidx: torch.Tensor,
                mask: torch.Tensor) -> PopularityTracker:
    """:func:`track` through the fused ``kernels.cms_update_query`` op.

    The estimates feeding the candidate table are the kernel's
    tile-ordered ones.  ``tr`` may carry a leading axis of trackers with
    ``mask`` [..., B] over the shared ``kidx[B]``: one kernel launch
    updates them all.
    """
    from repro_torch import kernels as kn

    hkey = hash128_u32(kidx)
    counts, est = kn.cms_update_query(hkey, mask.to(I32), tr.cms.counts)
    cand = merge_candidates_hashed(tr.cand, kidx, est, mask.to(torch.bool))
    return PopularityTracker(CountMinSketch(counts), cand)


def report_and_reset(tr: PopularityTracker, k: int,
                     ) -> tuple[PopularityTracker, torch.Tensor, torch.Tensor]:
    """Top-k report for the controller, then a fresh tracker (§3.8).

    Ranks by estimate, descending, ties in slot order (a stable sort, as
    ``jnp.argsort``); over the last axis of a batch of trackers."""
    order = torch.argsort(-tr.cand.est, dim=-1, stable=True)[..., :k]
    top_k = torch.gather(tr.cand.kidx, -1, order)
    top_e = torch.gather(tr.cand.est, -1, order)
    fresh = init_tracker(tr.cms.width, tr.cand.kidx.shape[-1],
                         tuple(tr.cand.kidx.shape[:-1]),
                         tr.cand.kidx.device)
    return fresh, top_k, top_e
