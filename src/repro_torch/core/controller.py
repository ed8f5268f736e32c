"""The host-side cache controller (port of ``repro.core.controller``).

Only :class:`CacheController` is ported: ``RackSimulator.preload`` installs
the hot set through it.  The traced in-scan ``controller_step`` belongs to
the control-plane slice.  The controller reads the switch tables to the
host, edits them in numpy exactly as the reference does, and writes them
back to the tables' device.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .hashing import hash128_u32_np
from .types import SwitchState


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
