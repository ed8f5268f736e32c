"""One run of one cell: set-up, the measured window, the traced stretch,
then the comparison with the reference.  :func:`run` returns the result
line's object; ``simbench/run.py`` is the command that prints it.
"""
from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import check
from .metrics import reader
from .spec import find_cell, merge
from .trace import Profiler, Stretch, span

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
STRETCH_WINDOWS = 200     # the least simulator windows a traced stretch spans


@dataclass
class RunData:
    """What a per-layer reader may read: the traced stretch, the chunk's
    counters, the rack's fields and the points a launch serves."""

    stretch: Stretch | None
    counters: dict
    rack: dict
    points: int


class MissingMetric(RuntimeError):
    """A per-layer metric that the manifest lists for the cell read
    nothing in a traced run on the card."""


def metrics_of(manifest: dict, section: str, cell: str) -> list[dict]:
    """The metrics of ``section`` that cell ``cell`` reports."""
    return [m for m in manifest[section]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer(manifest: dict, cell: str, run_data: RunData,
              strict: bool) -> dict:
    """The cell's per-layer metrics as its readers take them from
    ``run_data``.  ``strict`` (a traced run on the card): a listed metric
    that reads nothing fails the run rather than leaving the line."""
    out, missing = {}, []
    for m in metrics_of(manifest, "per_layer", cell):
        v = reader(m["name"]).read(run_data)
        if v is None:
            missing.append(m["name"])
        else:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if strict and missing:
        raise MissingMetric(f"{cell}: the traced run read nothing for "
                            f"{missing}")
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules of JAX or the JAX package, by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run(name: str, seed: int, seconds: float, trace: bool, t0: float,
        manifest: dict, device=None, overrides: dict | None = None,
        workers: int | None = None) -> dict:
    """Run cell ``name`` once; ``t0`` is the process's start on the
    ``time.perf_counter`` clock.  ``device`` None is the CUDA card;
    ``overrides`` (``{"config": ..., "traffic": ...}``) resize a cell for
    the CPU tests.  ``workers``: the reference's processes (default: one
    a CPU core on the card's machine, else this process alone)."""
    from .system import System

    _, config, traffic = find_cell(manifest, name)
    if overrides:
        config = merge(config, overrides.get("config", {}))
        traffic = merge(traffic, overrides.get("traffic", {}))
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    on_card = dev.type == "cuda"
    if workers is None:
        workers = (os.cpu_count() or 1) if on_card else 1

    # ---- set-up: build, preload, warm every graph the window replays ------
    system = System(config, traffic, seed, dev)
    system.preload()
    start = system.snapshot()
    system.call()       # captures every graph the window replays
    plan = check.sample_plan(seed, system.points)
    per_call = system.call_windows()
    prof_from = plan["call"] + 1
    prof_calls = max(1, math.ceil(STRETCH_WINDOWS / per_call))
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # ---- the measured window -----------------------------------------------
    first = first_after = sample = sample_before = sample_after = None
    sample_swaps = 0
    profiler = stretch = None
    attempted = failed = 0
    call_s: list[float] = []
    i = 0
    t_start = time.perf_counter()
    while True:
        if trace and on_card and i == prof_from:
            profiler = Profiler()
            profiler.start()
        if system.swap_due(i):
            with span("swap"):
                system.swap()
        if i == plan["call"]:
            with span("snapshot"):
                sample_before, = system.snapshot([plan["point"]])
            sample_swaps = system.swaps
        t_call = time.perf_counter()
        with span("call"):
            out, upd = system.call()
        call_s.append(time.perf_counter() - t_call)
        for traces, _, _ in out:
            attempted += per_call
            failed += max(0, per_call - len(traces["tx"]))
        if i == 0:
            first = (out, upd)
            with span("snapshot"):
                first_after = system.snapshot()
        if i == plan["call"]:
            sample = (out, upd)
            with span("snapshot"):
                sample_after, = system.snapshot([plan["point"]])
        i += 1
        if profiler is not None and i == prof_from + prof_calls:
            stretch = profiler.stop()
            stretch.windows = prof_calls * per_call
            stretch.periods = prof_calls if system.period_s else 0
            profiler = None
        done = (time.perf_counter() - t_start >= seconds
                and i > plan["call"] and profiler is None
                and (not trace or not on_card or stretch is not None))
        if done:
            break
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    rack_fields = system.rack_fields()
    counters = system.counters()
    points = system.points
    run_data = RunData(stretch=stretch, counters=counters, rack=rack_fields,
                       points=points)
    e2e = {"windows_per_s": attempted / wall,
           "peak_device_mib": peak / 2**20,
           "setup_s": setup_s}
    if trace:
        metrics = per_layer(manifest, name, run_data, strict=on_card)
    else:
        metrics = {}
        for m in metrics_of(manifest, "end_to_end", name):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}

    # ---- the program's state freed, then the reference ---------------------
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, notes = compare(config, traffic, seed, dev, start,
                             (first, first_after), plan,
                             (sample_before, sample, sample_after),
                             sample_swaps, workers)
    check_s = time.perf_counter() - t_check
    correct = all(numbers[k] <= check.LIMITS[k] for k in check.LIMITS)

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace and stretch is not None:
        device_info["busy_s"] = stretch.busy_s
        device_info["window_s"] = stretch.window_s
    if on_card:
        device_info["power"] = power_limit()
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics,
              "device": device_info}
    if trace and stretch is not None:
        result["breakdown"] = stretch.breakdown()
    info = {"windows_per_s": e2e["windows_per_s"], "setup_s": setup_s,
            "window_s": wall, "check_s": check_s, "calls": i,
            "sample_call": plan["call"], "sample_point": plan["point"],
            "workers": workers,
            "trace_reduce_s": stretch.reduce_s if stretch else None,
            "call_ms": [round(float(q) * 1e3, 2) for q in np.percentile(
                call_s, [0, 10, 50, 90, 100])]}
    print(f"run: {json.dumps(info)}", file=sys.stderr)
    for note in notes[:20]:
        print(f"check: {note}", file=sys.stderr)
    result["check"] = {k: {"value": numbers[k], "limit": check.LIMITS[k]}
                       for k in check.LIMITS}
    return result


def compare(config, traffic, seed, dev, start, first, plan, sample,
            sample_swaps, workers):
    """The reference's stretches against the port's: ``(numbers,
    notes)``.  ``start`` is every point's carry after the preload,
    ``first`` the port's first call and every point's carry after it,
    ``sample`` the sampled point's carry before the sampled call, the
    call and the carry after it."""
    spec = check.cell_spec(config, traffic, seed)
    n = len(spec.seeds)
    before, (s_out, s_upd), s_after = sample
    jobs = [check.start_job(spec, i, dev) for i in range(n)]
    jobs.append(check.sample_job(spec, plan["point"], before, sample_swaps,
                                 dev))
    ref = check.run_jobs(spec, jobs, workers)
    notes: list[str] = []
    numbers = dict.fromkeys(check.LIMITS, 0)
    (out, upd), after = first
    for i, (r_start, r_call, r_after) in enumerate(ref[:n]):
        where = f"call 0 point {i}"
        numbers["start_mismatch"] += check.differ(
            start[i], r_start, f"start point {i}", notes)
        numbers["call0_mismatch"] += check.call_differ(
            port_call(out, upd, i), r_call, where, notes)
        numbers["call0_mismatch"] += check.differ(
            after[i], r_after, where + " carry", notes)
    r_call, r_after = ref[n]
    where = f"call {plan['call']} point {plan['point']}"
    numbers["sample_mismatch"] += check.call_differ(
        port_call(s_out, s_upd, plan["point"]), r_call, where, notes)
    numbers["sample_mismatch"] += check.differ(s_after, r_after,
                                               where + " carry", notes)
    return numbers, notes


def port_call(out, upd, i):
    """Point ``i``'s part of one of the port's calls, in the reference's
    form ``((traces, hist_switch, hist_server), update)``."""
    traces, hs, hv = out[i]
    if upd is not None and len(out) > 1:
        upd = {k: np.asarray(v)[i] for k, v in upd.items()}
    return (traces, hs, hv), upd
