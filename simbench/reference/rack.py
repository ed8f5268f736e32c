"""The reference's driver: racks stepped window by window, eagerly.

:class:`Rack` mirrors what the benchmark asks of the port's
``RackSimulator``: its preload, chunks of windows and control-plane
periods.  A point of a fleet is a :class:`Rack` of its own (the port's
``BatchedRackSimulator`` holds each point equal to a serial rack).  Its
draws come from a source handed in: on the CPU, a
:class:`~.kvstore.client.RecordedDraws` of the card's generator.
"""
from __future__ import annotations

import numpy as np
import torch

from .baselines.netcache import netcache_install
from .core.controller import CacheController, ControllerConfig
from .kvstore.simulator import (
    RackConfig, build_fetch_batch, controller_window_apply, init_carry,
    make_client_config, make_server_config, window_step,
)
from .kvstore.workload import Workload

PRELOAD_WINDOWS = 16      # the windows an OrbitCache preload steps


def preload_windows(scheme: str) -> int:
    """The windows a rack's preload steps under ``scheme``."""
    return PRELOAD_WINDOWS if scheme == "orbitcache" else 0


def offered_per_window(cfg: RackConfig, offered_rps: float) -> float:
    """The requests a window offers, as ``init_carry`` puts them into the
    carry (then rounded to float32)."""
    return offered_rps * cfg.window_us * 1e-6


def _stack(rows):
    """A list of equal NamedTuples of tensors as one of ``[n, ...]``
    numpy arrays."""
    return {k: torch.stack([getattr(r, k) for r in rows]).cpu().numpy()
            for k in rows[0]._fields}


class Rack:
    """One rack under ``cfg.scheme``, drawing from ``draws``."""

    def __init__(self, cfg: RackConfig, wl: Workload, offered_rps: float,
                 write_ratio: float, draws, device):
        self.cfg, self.wl, self.device = cfg, wl, torch.device(device)
        self.server_cfg = make_server_config(cfg)
        self.client_cfg = make_client_config(cfg)
        self.ctrl_cfg = ControllerConfig(active_size=cfg.cache_entries,
                                         max_size=cfg.cache_entries)
        self.controller = CacheController(self.ctrl_cfg)
        self.carry = init_carry(cfg, self.server_cfg, self.client_cfg,
                                wl.cfg.num_keys, offered_rps, write_ratio,
                                draws, self.device)
        self.active = torch.tensor(self.controller.active_size,
                                   dtype=torch.int32, device=self.device)

    def preload(self, keys: np.ndarray) -> dict[str, np.ndarray] | None:
        """Install the hot set as the port's preload does; OrbitCache runs
        its :data:`PRELOAD_WINDOWS` windows, whose metrics are
        returned."""
        c = self.cfg
        if c.scheme == "orbitcache":
            sw, fetches = self.controller.preload(self.carry.policy, keys)
            self.active.fill_(self.controller.active_size)
            self.carry = self.carry._replace(
                policy=sw, fetch=build_fetch_batch(c, self.wl.vlen, fetches))
            return self.windows(PRELOAD_WINDOWS)
        if c.scheme == "netcache":
            st, _ = netcache_install(
                self.carry.policy, keys, self.wl.vlen_np[keys],
                key_size=self.wl.cfg.key_size,
                value_limit=c.netcache_value_limit)
            self.carry = self.carry._replace(policy=st)
        return None

    def windows(self, n: int) -> dict[str, np.ndarray]:
        """``n`` windows: their metrics, ``[n, ...]``."""
        rows = []
        for _ in range(n):
            self.carry, m = window_step(self.cfg, self.server_cfg,
                                        self.client_cfg, self.wl.cfg.key_size,
                                        self.wl.arrays, self.carry)
            rows.append(m)
        return _stack(rows)

    def period(self) -> dict[str, np.ndarray]:
        """One control-plane period boundary: its update, ``[1, ...]``."""
        self.carry, self.active, upd, _ = controller_window_apply(
            self.cfg, self.ctrl_cfg, self.wl.arrays, self.carry, self.active)
        return _stack([upd])
