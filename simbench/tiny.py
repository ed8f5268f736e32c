"""Every cell at a size the CPU tests can hold: 4 servers, a 64-lane
client batch, 4,096 keys, calls of 8 windows (periods of 8, swaps every 2
periods, a fleet of 3 points).  The cell's layers and paths are the
card's; only the sizes shrink.

Beside the manifest's cells, the two OrbitCache single-rack cells that
``BENCHMARK.json`` holds back (their rate on the card is bimodal, see
``PERF.md``) run here too, with their kernels' roofline readers, so that
their traffic and readers stay tested for the change that brings them
back."""
from __future__ import annotations

import os
import time

from . import cell
from .spec import ROOT, find_cell, load_json, merge

BASE = {"config": {"rack": {"num_servers": 4, "client_batch": 64,
                            "fetch_lanes": 16, "cache_entries": 16,
                            "netcache_entries": 200,
                            "netcache_table": 1024},
                   "workload": {"num_keys": 4096}, "preload_keys": 16},
        "traffic": {"offered_rps": 300000.0, "chunk_windows": 8}}
PER_CELL = {
    "netcache-rack.static-4m": {"config": {"preload_keys": 200}},
    "orbitcache-rack.churn": {"traffic": {"controller_period_s": 0.0008,
                                          "swap_keys": 8,
                                          "swap_every_periods": 2}},
    "orbitcache-rack.ladder12": {"traffic": {
        "points": {"offered_rps": [100000.0, 200000.0, 300000.0]}}},
}


HELD_CELLS = [
    {"name": "orbitcache-rack.static-4m", "config": "orbitcache-paper-rack",
     "traffic": "static-4m", "chips": 1},
    {"name": "orbitcache-rack.churn", "config": "orbitcache-paper-rack",
     "traffic": "churn", "chips": 1},
]
HELD_METRICS = [
    {"name": name, "unit": "%", "better": "higher", "source": "device_trace",
     "layer": "kernels", "moves": "windows_per_s",
     "workloads": ["orbitcache-rack.churn"]}
    for name in ("cms_roofline", "hot_gather_roofline")]


def manifest() -> dict:
    """``BENCHMARK.json`` with the held-back cells and metrics."""
    man = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    man["workloads"] += HELD_CELLS
    man["per_layer"] += HELD_METRICS
    return man


def overrides(name: str) -> dict:
    return merge(BASE, PER_CELL.get(name, {}))


def sized(name: str) -> tuple[dict, dict]:
    """``(configuration, traffic)`` of cell ``name`` at the tiny size."""
    _, config, traffic = find_cell(manifest(), name)
    ov = overrides(name)
    return (merge(config, ov.get("config", {})),
            merge(traffic, ov.get("traffic", {})))


def run(name: str, seed: int = 12345, trace: bool = False) -> dict:
    """One run of cell ``name`` on the CPU at the tiny size, past the
    harness's look for a card."""
    return cell.run(name, seed, 0.0, trace, time.perf_counter(), manifest(),
                    device="cpu", overrides=overrides(name))
