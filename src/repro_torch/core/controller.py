"""The cache controller (port of ``repro.core.controller``, paper §3.8
and §3.10).

Two implementations of one cache-update period:

* :class:`CacheController`, the host oracle: it reads the switch tables
  to the host, edits them in numpy exactly as the reference does, and
  writes them back to the tables' device (``RackSimulator.preload``
  installs the hot set through it);
* :func:`controller_step`, the device form the periodic simulator runs:
  tensor ops and three ``kernels.hot_gather`` launches, no host read.
  It equals the oracle on every output.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from .hashing import hash128_u32, hash128_u32_np, to_u32
from .scatter_free import unique_writer
from .types import COUNTER_DTYPE, SwitchState, device_const


@dataclass(frozen=True)
class ControllerConfig:
    active_size: int = 128
    min_size: int = 32
    max_size: int = 512
    size_step: int = 32
    overflow_threshold: float = 0.01
    dynamic_sizing: bool = False
    k_report: int = 64


@dataclass
class UpdateInfo:
    evicted: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    inserted: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    fetches: list[tuple[int, int]] = field(default_factory=list)  # (kidx, cidx)
    overflow_ratio: float = 0.0
    active_size: int = 0


def _resize_decision(overflow, cached_reqs, threshold):
    """``ratio > threshold`` as a float32 product, as the reference."""
    return (np.float32(overflow)
            > np.float32(threshold) * np.float32(cached_reqs))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class CacheController:
    """Host-side cache-update controller."""

    def __init__(self, cfg: ControllerConfig):
        self.cfg = cfg
        self.active_size = cfg.active_size

    def resize(self, overflow: int, cached_reqs: int) -> float:
        """§3.10 dynamic sizing; a zero-traffic period holds the size."""
        ratio = overflow / max(cached_reqs, 1)
        if self.cfg.dynamic_sizing and cached_reqs > 0:
            if _resize_decision(overflow, cached_reqs,
                                self.cfg.overflow_threshold):
                self.active_size = max(self.cfg.min_size,
                                       self.active_size - self.cfg.size_step)
            else:
                self.active_size = min(self.cfg.max_size,
                                       self.active_size + self.cfg.size_step)
        return ratio

    def update(self, sw: SwitchState,
               reports: list[tuple[np.ndarray, np.ndarray]],
               overflow: int = 0, cached_reqs: int = 0,
               ) -> tuple[SwitchState, UpdateInfo]:
        """One control-plane period: merge popularity, evict/insert.

        A key reported by several servers scores the SUM of its estimates;
        ranking is (score desc, key asc).  New keys inherit evicted
        CacheIdx slots first.  Period accumulators reset to zero.
        """
        ratio = self.resize(overflow, cached_reqs)
        cap = sw.lookup.occupied.shape[0]
        active = min(self.active_size, cap)

        occ = _np(sw.lookup.occupied)
        cached_kidx = _np(sw.lookup.kidx)
        pop = _np(sw.counters.popularity)

        scores: dict[int, int] = {}
        for c in range(cap):
            if occ[c]:
                scores[int(cached_kidx[c])] = int(pop[c])
        for top_k, top_e in reports:
            for k, e in zip(np.asarray(top_k), np.asarray(top_e)):
                k = int(k)
                if k >= 0:
                    scores[k] = scores.get(k, 0) + int(e)

        desired = sorted(scores, key=lambda k: (-scores[k], k))[:active]
        desired_set = set(desired)
        current = {int(cached_kidx[c]): c for c in range(cap) if occ[c]}
        evict = [c for k, c in current.items() if k not in desired_set]
        new_keys = [k for k in desired if k not in current]
        free = [c for c in range(cap) if not occ[c]]
        slots = evict + free

        hkeys = _np(sw.lookup.hkeys).copy()
        occupied = occ.copy()
        kidx_arr = cached_kidx.copy()
        valid = _np(sw.state.valid).copy()
        version = _np(sw.state.version).copy()
        live = _np(sw.orbit.live).copy()
        f = sw.orbit.max_frags

        fetches: list[tuple[int, int]] = []
        inserted = []
        evicted_keys = [int(cached_kidx[c]) for c in evict]
        used = 0
        for k in new_keys:
            if used >= len(slots):
                break
            c = slots[used]
            used += 1
            hkeys[c] = hash128_u32_np(np.int32(k)).view(np.int32)
            occupied[c] = True
            kidx_arr[c] = k
            valid[c] = False          # invalid until the F-REP arrives
            version[c] += 1           # stale lines (old key) must drop
            live[c * f:(c + 1) * f] = False
            fetches.append((int(k), int(c)))
            inserted.append(int(k))
        for c in evict[used:]:
            occupied[c] = False
            kidx_arr[c] = -1
            valid[c] = False
            version[c] += 1
            live[c * f:(c + 1) * f] = False

        dev = sw.lookup.hkeys.device
        t = lambda a: torch.from_numpy(a).to(dev)
        ctr = sw.counters
        sw2 = sw._replace(
            lookup=sw.lookup._replace(hkeys=t(hkeys), occupied=t(occupied),
                                      kidx=t(kidx_arr)),
            state=sw.state._replace(valid=t(valid), version=t(version)),
            orbit=sw.orbit._replace(live=t(live)),
            counters=ctr._replace(
                popularity=torch.zeros_like(ctr.popularity),
                overflow=torch.zeros_like(ctr.overflow),
                cached_reqs=torch.zeros_like(ctr.cached_reqs)),
        )
        info = UpdateInfo(
            evicted=np.asarray(evicted_keys, np.int32),
            inserted=np.asarray(inserted, np.int32),
            fetches=fetches, overflow_ratio=ratio,
            active_size=self.active_size,
        )
        return sw2, info

    def preload(self, sw: SwitchState, keys: np.ndarray,
                ) -> tuple[SwitchState, list[tuple[int, int]]]:
        """Install an initial hot set; returns the fetches to issue.

        Estimates descend with position so the caller's hotness order
        survives the ranking even when ``keys`` exceeds the active size."""
        keys = np.asarray(keys, np.int32)
        est = (1 << 20) - np.arange(len(keys), dtype=np.int32)
        sw2, info = self.update(sw, [(keys, est)])
        return sw2, info.fetches


# ---------------------------------------------------------------------------
# the device control plane (twin of CacheController)
# ---------------------------------------------------------------------------
_I32_MAX = 2**31 - 1
_U32_MAX = 2**32 - 1
I32, F32 = torch.int32, torch.float32


class TracedUpdate(NamedTuple):
    """Fixed-width outputs of one :func:`controller_step` period.

    ``fetch_*`` are the F-REQ lanes (lane ``i`` is the ``i``-th inserted
    key, the oracle's ``fetches`` order); ``evicted_*`` the evicted keys in
    slot order.  Widths equal the lookup capacity.
    """

    fetch_kidx: torch.Tensor     # int32[cap] inserted keys (-1 pad)
    fetch_cidx: torch.Tensor     # int32[cap] inherited CacheIdx per fetch
    fetch_valid: torch.Tensor    # bool[cap]
    evicted_kidx: torch.Tensor   # int32[cap] evicted keys (-1 pad)
    evicted_valid: torch.Tensor  # bool[cap]
    n_insert: torch.Tensor       # int32[]
    n_evict: torch.Tensor        # int32[]
    overflow_ratio: torch.Tensor  # float32[] period overflow ratio (§3.10)


def _traced_resize(cfg: ControllerConfig, active_size, overflow,
                   cached_reqs):
    """Device twin of :meth:`CacheController.resize`; the shrink test is
    :func:`_resize_decision` term for term in float32."""
    ovf = overflow.to(F32)
    cr = cached_reqs.to(F32)
    ratio = ovf / torch.clamp(cr, min=1.0)
    if not cfg.dynamic_sizing:
        return active_size, ratio
    traffic = cached_reqs > 0
    thr = device_const(np.float32(cfg.overflow_threshold), F32, cr.device)
    shrink = traffic & (ovf > thr * cr)
    grow = traffic & ~shrink
    smaller = torch.clamp(active_size - cfg.size_step, min=cfg.min_size)
    larger = torch.clamp(active_size + cfg.size_step, max=cfg.max_size)
    return torch.where(shrink, smaller,
                       torch.where(grow, larger, active_size)).to(I32), ratio


def _merge_scores(occ, cached_kidx, popularity, report_kidx, report_est):
    """Merge cached popularity with the server reports through three
    ``kernels.hot_gather`` calls.

    Per cached key: its popularity plus the summed estimates of every
    report lane naming it.  Per report lane: the summed estimate of all
    lanes with its key, and whether the key is cached.  One canonical lane
    (the first) stands for each distinct uncached reported key.  Returns
    ``(cand_key int32[M], cand_score int64[M])`` (uint32 scores), ``M =
    cap + report lanes``, masked lanes at ``(INT32_MAX, 0)``.
    """
    from repro_torch import kernels as kn

    rvalid = report_kidx >= 0
    est = torch.where(rvalid, report_est, 0).to(I32)
    # distinct sentinels, so that invalid lanes never match anything
    ids_cached = torch.where(occ, cached_kidx, -3)
    hot_report = torch.where(rvalid, report_kidx, -2)
    ids_report = torch.where(rvalid, report_kidx, -3)
    hot_cached = torch.where(occ, cached_kidx, -2)

    rsum, _ = kn.hot_gather(ids_cached, hot_report, est[:, None])
    cached_score = (popularity + to_u32(rsum[:, 0])) & _U32_MAX

    tot, _ = kn.hot_gather(ids_report, hot_report, est[:, None])
    _, in_cache = kn.hot_gather(
        ids_report, hot_cached,
        torch.zeros((occ.shape[0], 1), dtype=I32, device=occ.device))
    # canonical lane: the first occurrence of its key among the lanes
    eq = (hot_report[:, None] == hot_report[None, :]) & rvalid[None, :]
    n_r = report_kidx.shape[0]
    first = torch.argmax(eq.to(I32), dim=1) == torch.arange(
        n_r, device=occ.device)
    canonical = rvalid & first & ~(in_cache > 0)

    cand_key = torch.cat([torch.where(occ, cached_kidx, _I32_MAX),
                          torch.where(canonical, report_kidx, _I32_MAX)])
    cand_score = torch.cat([torch.where(occ, cached_score, 0),
                            torch.where(canonical, to_u32(tot[:, 0]), 0)])
    return cand_key.to(I32), cand_score.to(COUNTER_DTYPE)


def controller_step(
    sw: SwitchState,
    report_kidx: torch.Tensor,   # int32[Nr] candidate keys (-1 = empty lane)
    report_est: torch.Tensor,    # int32[Nr] per-lane popularity estimates
    overflow: torch.Tensor,      # int64[] (uint32) period overflow count
    cached_reqs: torch.Tensor,   # int64[] (uint32) period cached requests
    active_size: torch.Tensor,   # int32[] current size
    cfg: ControllerConfig,
    *,
    install_live: bool = False,
    report_vlen: torch.Tensor | None = None,  # int32[Nr], install_live only
) -> tuple[SwitchState, torch.Tensor, TracedUpdate]:
    """One control-plane period on the device (paper §3.8/§3.10).

    The twin of :meth:`CacheController.update`: the same merge, the same
    (score desc, key asc) ranking, CacheIdx inheritance and counter
    resets, with no host read.  ``install_live=True`` is the spine
    controller's mode: inserted entries go live at once as
    metadata-served lines (value length from ``report_vlen``), and kept
    entries that a write invalidated re-validate with a version bump.

    Returns ``(sw', active_size', TracedUpdate)``.
    """
    lk, st, orb = sw.lookup, sw.state, sw.orbit
    cap = lk.occupied.shape[0]
    f = orb.max_frags
    occ, ck = lk.occupied, lk.kidx
    dev = occ.device
    ar = lambda m: torch.arange(m, device=dev)
    excl = lambda m: (torch.cumsum(m.to(I32), 0, dtype=I32)
                      - m.to(I32))           # exclusive running count

    # ---- §3.10 sizing (before selection, as the oracle) -------------------
    active_size, ratio = _traced_resize(cfg, active_size, overflow,
                                        cached_reqs)
    active = torch.clamp(active_size, max=cap)

    # ---- merge + rank: the top ``active`` candidates ----------------------
    cand_key, cand_score = _merge_scores(occ, ck, sw.counters.popularity,
                                         report_kidx, report_est)
    inv = _U32_MAX - cand_score
    # score desc, key asc, pads last (jnp.lexsort((cand_key, inv)))
    o = torch.argsort(cand_key, stable=True)
    order = o[torch.argsort(inv[o], stable=True)]
    dkey = cand_key[order][:cap]
    dok = (ar(cap) < active) & (dkey != _I32_MAX)
    dkey_m = torch.where(dok, dkey, -2)

    # ---- membership (sentinels -2 / -3 never cross-match) -----------------
    occ_key = torch.where(occ, ck, -3)
    keep = torch.any(occ_key[:, None] == dkey_m[None, :], dim=1)
    d_cached = torch.any(dkey_m[:, None] == occ_key[None, :], dim=1) & dok

    new_mask = dok & ~d_cached             # desired order == rank order
    evict_mask = occ & ~keep
    free_mask = ~occ

    new_rank = excl(new_mask)
    n_new = torch.sum(new_mask, dtype=I32)
    rank_wr, rank_wn = unique_writer(torch.where(new_mask, new_rank, cap),
                                     new_mask, cap)
    key_at_rank = torch.where(rank_wn, dkey[rank_wr], -1)

    # slot order: evicted CacheIdx first (§3.8), then free slots
    n_evict = torch.sum(evict_mask, dtype=I32)
    ev_rank = excl(evict_mask)
    fr_rank = n_evict + excl(free_mask)
    slot_rank = torch.where(evict_mask, ev_rank, fr_rank)
    assigned = (evict_mask | free_mask) & (slot_rank < n_new)
    safe_rank = torch.clamp(slot_rank, 0, cap - 1).long()
    slot_key = torch.where(assigned, key_at_rank[safe_rank], -1)
    vacated = evict_mask & ~assigned
    changed = assigned | vacated

    # ---- lookup / state ----------------------------------------------------
    new_occ = (occ & keep) | assigned
    new_kidx = torch.where(assigned, slot_key,
                           torch.where(occ & keep, ck, -1))
    new_hkeys = torch.where(assigned[:, None], hash128_u32(slot_key),
                            lk.hkeys)
    if install_live:
        revalive = occ & keep & ~st.valid
        touched = changed | revalive
        new_valid = (st.valid & ~changed) | assigned | revalive
    else:
        revalive = torch.zeros_like(occ)
        touched = changed
        new_valid = st.valid & ~changed
    new_version = st.version + touched.to(I32)

    # ---- orbit lines -------------------------------------------------------
    ent = ar(cap)[:, None].expand(cap, f).reshape(-1)   # line -> entry
    live2 = orb.live & ~changed[ent]
    if install_live:
        if report_vlen is None:
            raise ValueError("install_live requires report_vlen")
        rvlen = torch.where(report_kidx >= 0, report_vlen, 0)
        cand_vlen = torch.cat([torch.zeros(cap, dtype=I32, device=dev),
                               rvlen.to(I32)])
        dvlen = cand_vlen[order][:cap]
        vlen_at_rank = torch.where(rank_wn, dvlen[rank_wr], 0)
        slot_vlen = torch.where(assigned, vlen_at_rank[safe_rank], 0)
        frag0 = (ar(cap * f) % f) == 0
        a_line = assigned[ent] & frag0
        r_line = revalive[ent] & frag0
        orbit2 = orb._replace(
            live=live2 | a_line | r_line,
            kidx=torch.where(a_line, slot_key[ent], orb.kidx),
            version=torch.where(a_line | r_line, new_version[ent],
                                orb.version),
            vlen=torch.where(a_line, slot_vlen[ent], orb.vlen),
            frags=torch.where(assigned, 1, orb.frags).to(orb.frags.dtype),
        )
    else:
        orbit2 = orb._replace(live=live2)

    ctr = sw.counters
    sw2 = sw._replace(
        lookup=lk._replace(hkeys=new_hkeys, occupied=new_occ,
                           kidx=new_kidx),
        state=st._replace(valid=new_valid, version=new_version),
        orbit=orbit2,
        counters=ctr._replace(
            popularity=torch.zeros_like(ctr.popularity),
            overflow=torch.zeros_like(ctr.overflow),
            cached_reqs=torch.zeros_like(ctr.cached_reqs)),
    )

    # ---- fixed-width F-REQ / eviction lanes --------------------------------
    cidx_wr, cidx_wn = unique_writer(torch.where(assigned, slot_rank, cap),
                                     assigned, cap)
    ev_wr, ev_wn = unique_writer(torch.where(evict_mask, ev_rank, cap),
                                 evict_mask, cap)
    upd = TracedUpdate(
        fetch_kidx=key_at_rank,
        fetch_cidx=torch.where(cidx_wn, cidx_wr.to(I32), -1),
        fetch_valid=rank_wn,
        evicted_kidx=torch.where(ev_wn, ck[ev_wr], -1),
        evicted_valid=ev_wn,
        n_insert=n_new,
        n_evict=n_evict,
        overflow_ratio=ratio,
    )
    return sw2, active_size, upd
