"""``run_lint`` and the ``python -m repro_torch.analysis.lint`` CLI (port
of ``repro.analysis.lint``).

The CLI builds the six production entry points on a device (the CUDA
card unless ``--device cpu``), runs every registered rule, prints the
findings and exits nonzero on any error-severity finding.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

from .entry_points import build_entry_points
from .findings import Finding, Severity, errors
from .rules import RULES


def run_lint(entries=None, rules=None, device=None) -> list[Finding]:
    """Run ``rules`` (default: all) over ``entries`` (default: all six,
    built on ``device``).

    A rule that crashes yields an error finding instead of aborting the
    sweep (a linter that dies on one entry checks nothing on the rest).
    """
    if entries is None:
        entries = build_entry_points(device=device)
    rule_fns = [(n, RULES[n]) for n in (rules or RULES)]
    findings: list[Finding] = []
    for entry in entries:
        for name, fn in rule_fns:
            try:
                findings.extend(fn(entry))
            except Exception:
                findings.append(Finding(
                    rule=name, severity=Severity.ERROR, entry=entry.name,
                    message="rule crashed:\n"
                            + traceback.format_exc(limit=5)))
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Lint the port's structural invariants (op traces of "
                    "the bodies, kernel counts, counters, chunk memory, "
                    "graph captures).")
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="where the entries run (default: the CUDA card)")
    ap.add_argument("--entries", default=None,
                    help="comma-separated entry-point names (default: all)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule names (default: all)")
    ap.add_argument("--list", action="store_true",
                    help="list rules and entry points, then exit")
    args = ap.parse_args(argv)

    if args.list:
        print("rules:")
        for name, fn in RULES.items():
            doc = (fn.__doc__ or "").strip().splitlines()[0]
            print(f"  {name:20s} {doc}")
        print("entry points:")
        for e in build_entry_points(device="cpu"):
            print(f"  {e.name:28s} calls a run: {e.calls}")
        return 0

    rules = args.rules.split(",") if args.rules else None
    if rules:
        unknown = set(rules) - set(RULES)
        if unknown:
            ap.error(f"unknown rules: {sorted(unknown)}")
    entries = build_entry_points(
        args.entries.split(",") if args.entries else None, args.device)

    from repro_torch.kernels import kernel_backend
    dev = entries[0].device
    print(f"repro_torch.analysis.lint: {len(rules or RULES)} rules x "
          f"{len(entries)} entry points on {dev} (kernel backend: "
          f"{kernel_backend(dev)})", flush=True)
    t0 = time.perf_counter()
    findings = run_lint(entries, rules)
    for f in findings:
        print(f.format(), flush=True)
    errs = errors(findings)
    warns = len(findings) - len(errs)
    print(f"repro_torch.analysis.lint: {len(errs)} error(s), {warns} "
          f"warning(s) in {time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if errs else 0


if __name__ == "__main__":
    sys.exit(main())
