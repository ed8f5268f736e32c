"""A cell's specification: its entry in ``BENCHMARK.json``, its
configuration file and its traffic file, and the simulator settings they
give for a seed.  Read by the harness and by the reference alike; imports
nothing of the port."""
from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s entries, nested dicts merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def find_cell(manifest: dict, name: str) -> tuple[dict, dict, dict]:
    """``(cell, configuration, traffic)`` of workload ``name``."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the benchmark has "
                         f"{sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     f"{cell['traffic']}.json"))
    return cell, config, traffic


def rack_config(config: dict, traffic: dict, seed: int) -> dict:
    """The ``RackConfig`` fields of a cell: the configuration's, the
    traffic's mode switches over them, and the seed."""
    return {**config["rack"], **traffic.get("rack", {}), "seed": seed}


def workload_config(config: dict, traffic: dict, seed: int) -> dict:
    """The ``WorkloadConfig`` fields of a cell; the seed sets the value
    sizes (``value_seed``) and the draws."""
    w = dict(config["workload"])
    w["value_sizes"] = tuple(tuple(v) for v in w["value_sizes"])
    return {**w, "offered_rps": float(traffic.get("offered_rps", 0.0)),
            "write_ratio": float(traffic.get("write_ratio", 0.0)),
            "seed": seed, "value_seed": seed}


def point_seeds(traffic: dict, seed: int) -> list[int]:
    """The draw seeds of a cell's racks: ``seed``, and in a fleet ``seed
    + 1``, ... for its further points."""
    if "points" not in traffic:
        return [seed]
    return [seed + i for i in range(len(traffic["points"]["offered_rps"]))]
