"""Run one cell of the benchmark once and print its result line.

    python -m simbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout, on a machine with a CUDA card.  The last
line of standard output is the result's JSON object; the last lines of
standard error are the numbers compared, each beside its limit.  Exits 1
with no result where there is no card, where the port or the manifest is
missing, where a traced run reads nothing for a per-layer metric the cell
lists, or where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_env() -> None:
    """Keep every build and cache of the run inside the checkout or the
    run's own home, cache and temporary directories."""
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, ".torch_ext_build", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(ROOT, ".torch_ext_build", "ext"))
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    build_env()

    import torch

    manifest_path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(manifest_path):
        print("no BENCHMARK.json at the checkout's root", file=sys.stderr)
        return 1
    with open(manifest_path) as f:
        manifest = json.load(f)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("the port (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 1
    need = int(cells[args.workload]["chips"])
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < need:
        print(f"the cell needs {need} CUDA card(s); torch sees {seen}",
              file=sys.stderr)
        return 1

    from simbench import cell

    try:
        result = cell.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), T0, manifest)
    except cell.MissingMetric as e:
        print(e, file=sys.stderr)
        return 1
    found = cell.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark runs the port alone",
              file=sys.stderr)
        return 1
    for k, v in result["check"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
