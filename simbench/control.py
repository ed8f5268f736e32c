"""The control of the comparison: the reference put in the port's place
with its float32 sites in bfloat16 (:mod:`simbench.reference.precision`),
held to the float32 reference by the same numbers as a run.

    python -m simbench.control --workload <name> --seeds 1,2,3

prints one JSON line a seed with ``start_mismatch`` and
``call0_mismatch`` over every point (the sample stretch follows the
port's own state, so the control's start is what it is judged by).  A
sound comparison reads them above its limit of 0 on every seed.  Both
sides run on the CPU as a run's reference does, their draws made on the
card; the CPU tests call :func:`control_numbers` at a tiny size.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from . import check
from .spec import ROOT, find_cell, load_json


def control_numbers(config: dict, traffic: dict, seed: int, device,
                    low: torch.dtype = torch.bfloat16,
                    workers: int = 1) -> dict:
    """The numbers a run compares, with the control in the port's place;
    ``device`` makes the draws."""
    spec = check.cell_spec(config, traffic, seed)
    n = len(spec.seeds)
    jobs = [check.start_job(spec, i, device, lo) for lo in (low, None)
            for i in range(n)]
    res = check.run_jobs(spec, jobs, workers)
    notes: list[str] = []
    numbers = {"start_mismatch": 0, "call0_mismatch": 0}
    for i, ((g_start, g_call, g_after), (w_start, w_call, w_after)) in \
            enumerate(zip(res[:n], res[n:])):
        numbers["start_mismatch"] += check.differ(g_start, w_start,
                                                  f"start {i}", notes)
        numbers["call0_mismatch"] += check.call_differ(
            g_call, w_call, f"call 0 {i}", notes)
        numbers["call0_mismatch"] += check.differ(
            g_after, w_after, f"call 0 {i} carry", notes)
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    manifest = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    _, config, traffic = find_cell(manifest, args.workload)
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = control_numbers(config, traffic, seed, dev,
                                  workers=os.cpu_count() or 1)
        limits = {k: check.LIMITS[k] for k in numbers}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": numbers, "limits": limits,
                          "fails": any(numbers[k] > limits[k]
                                       for k in numbers),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

