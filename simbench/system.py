"""The system under test: the port's rack simulator (``repro_torch``),
built from a cell's configuration and traffic and driven through its own
entry points, ``RackSimulator.run`` and ``BatchedRackSimulator.run``.

This is the only module of the benchmark that imports the port.  A *call*
is one ``run`` of the simulator: ``chunk_windows`` windows, or with a
controller period one period, whose metrics the host reads back.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

from repro_torch import kernels as kn  # noqa: E402
from repro_torch.kvstore.fleet import BatchedRackSimulator  # noqa: E402
from repro_torch.kvstore.simulator import (  # noqa: E402
    RackConfig, RackSimulator,
)
from repro_torch.kvstore.workload import (  # noqa: E402
    Workload, WorkloadConfig,
)

from .check import flatten, swap_due  # noqa: E402
from .spec import point_seeds, rack_config, workload_config  # noqa: E402


class System:
    """One cell's simulator on ``device``: a rack, or a fleet of points
    (``traffic["points"]``)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.cfg = RackConfig(**rack_config(config, traffic, seed))
        self.wl = Workload(WorkloadConfig(**workload_config(config, traffic,
                                                            seed)),
                           device=self.device)
        self.window_s = self.cfg.window_us * 1e-6
        self.period_s = traffic.get("controller_period_s")
        self.chunk = int(traffic.get("chunk_windows", 256))
        self.swap_keys = int(traffic.get("swap_keys", 0))
        self.fleet = "points" in traffic
        if self.fleet:
            self.sim = BatchedRackSimulator(
                self.cfg, self.wl,
                offered_rps=traffic["points"]["offered_rps"],
                seeds=point_seeds(traffic, seed), device=self.device)
            self.points = self.sim.n_points
        else:
            self.sim = RackSimulator(self.cfg, self.wl, device=self.device)
            self.points = 1
        self.swaps = 0          # hot-in swaps made

    # -- set-up ---------------------------------------------------------
    def preload(self) -> None:
        k = int(self.config["preload_keys"])
        if self.fleet:
            self.sim.preload([self.wl.hottest_keys(k)] * self.points)
        else:
            self.sim.preload(self.wl.hottest_keys(k))

    def call_windows(self) -> int:
        """Simulator windows in one call."""
        if self.period_s:
            return int(round(self.period_s / self.window_s))
        return self.chunk

    # -- one call -------------------------------------------------------
    def swap_due(self, i: int) -> bool:
        """Whether timed call ``i`` starts a churn phase (a swap of the
        hottest keys with the coldest before it)."""
        return swap_due(self.traffic, i)

    def swap(self) -> None:
        self.wl.hot_in_swap(self.swap_keys)
        self.swaps += 1
        if self.fleet:
            self.sim.refresh_workloads()

    def call(self):
        """One ``run`` of the simulator: ``(per point (traces, hist_switch,
        hist_server), period update or None)``, on the host."""
        n = self.call_windows()
        if self.fleet:
            res = self.sim.run(n * self.window_s, chunk_windows=n,
                               controller_period_s=self.period_s)
        else:
            res = [self.sim.run(n * self.window_s, chunk_windows=n,
                                controller_period_s=self.period_s)]
        upd = getattr(self.sim, "_last_update", None) if self.period_s \
            else None
        # copies: on the CPU the port's arrays can alias its buffers
        out = [({k: np.array(v) for k, v in r.traces.items()},
                np.array(r.hist_switch), np.array(r.hist_server))
               for r in res]
        return out, (None if upd is None
                     else {k: np.array(v) for k, v in upd._asdict().items()})

    # -- state ----------------------------------------------------------
    def snapshot(self, points=None) -> list[dict]:
        """The carry of each point (``points``: which; default all) as
        host tensors by field path, with its draw state and cache size."""
        flat = flatten(self.sim.carry)
        if self.fleet:
            pts = range(self.points) if points is None else points
            srcs = self.sim.carry.draws.sources
            return [dict({k: v[i].to("cpu", copy=True)
                          for k, v in flat.items()},
                         _draws=srcs[i].get_state().clone(),
                         _active=self.sim.controllers[i].active_size)
                    for i in pts]
        return [dict({k: v.to("cpu", copy=True) for k, v in flat.items()},
                     _draws=self.sim.carry.draws.get_state().clone(),
                     _active=self.sim.controller.active_size)]

    def counters(self) -> dict:
        """The chunk's own counters: capture time, graphs, their pools,
        and the kernel launches so far."""
        ch = self.sim.chunk
        return dict(capture_s=ch.capture_seconds, captures=ch.captures,
                    graph_bytes=dict(ch.graph_bytes),
                    launches=dict(kn.LAUNCHES))

    def rack_fields(self) -> dict:
        return dataclasses.asdict(self.cfg)

