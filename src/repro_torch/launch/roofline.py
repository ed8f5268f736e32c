"""Roofline report from dry-run records (port of ``repro.launch.roofline``).

Hardware model, per device: one NVIDIA H100 80GB HBM3 (SXM) at its 700 W
power limit, from NVIDIA's data sheet (dense rates, no sparsity):

    peak bf16 compute   989 TFLOP/s
    HBM3 bandwidth      3.35 TB/s
    NVLink 4            450 GB/s per direction

Terms (seconds, per step, per device -- the dry run's op trace is each
rank's local program, so its totals are already per device):

    compute    = dot FLOPs / peak
    memory     = (HBM bytes - bf16_upcast_bytes) / HBM bandwidth
    collective = collective wire bytes / link bandwidth

The production mesh's 16-wide model axis spans two 8-GPU NVLink domains,
so part of its traffic crosses the slower inter-node network: the
collective term is a lower bound there.  ``terms`` takes each constant as
a keyword, so another card (or the reference's TPU model, which the tests
pass in to check the arithmetic) can be plugged in.

MODEL_FLOPS uses 6*N*D (train; D = tokens) / 2*N*D (inference), with
N_active for MoE.  The MODEL/trace ratio flags remat + redundant compute.
"""
from __future__ import annotations

import argparse
import json
import os

PEAK_FLOPS = 989e12   # H100 SXM dense bf16, NVIDIA data sheet, 700 W
HBM_BW = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
LINK_BW = 450e9       # NVLink 4, 900 GB/s bidirectional per GPU (data sheet)

ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def model_flops_per_chip(r: dict) -> float:
    """Analytic useful FLOPs per step per device."""
    shape = r["shape"]
    n_act = r["active_param_count"]
    chips = r["devices"]
    if shape == "train_4k":
        tokens = 256 * 4096
        return 6.0 * n_act * tokens / chips
    if shape == "prefill_32k":
        tokens = 32 * 32768
        return 2.0 * n_act * tokens / chips
    if shape == "decode_32k":
        return 2.0 * n_act * 128 / chips
    if shape == "long_500k":
        return 2.0 * n_act * 1 / chips
    raise ValueError(shape)


def terms(r: dict, *, peak_flops: float = PEAK_FLOPS,
          hbm_bw: float = HBM_BW, link_bw: float = LINK_BW) -> dict:
    a = r["analysis"]
    comp = a["flops"] / peak_flops
    mem = max(a["hbm_bytes"] - a.get("bf16_upcast_bytes", 0), 0) / hbm_bw
    coll = a["collective_wire_bytes"] / link_bw
    dom = max(("compute", comp), ("memory", mem), ("collective", coll),
              key=lambda kv: kv[1])
    mf = model_flops_per_chip(r)
    return dict(
        compute_s=comp, memory_s=mem, collective_s=coll,
        dominant=dom[0], bound_s=dom[1],
        model_flops=mf,
        useful_ratio=(mf / a["flops"]) if a["flops"] else 0.0,
        roofline_frac=(mf / peak_flops) / dom[1] if dom[1] > 0 else 0.0,
    )


def remedy(r: dict, t: dict) -> str:
    d = t["dominant"]
    if d == "compute":
        if t["useful_ratio"] < 0.5:
            return ("compute-bound but <50% useful: relax remat policy / "
                    "cut redundant recompute")
        return "compute-bound near peak: raise arithmetic intensity per chip"
    if d == "memory":
        if "decode" in r["shape"] or r["shape"] == "long_500k":
            return ("HBM-bound (expected for decode): shrink cache reads — "
                    "quantize KV to int8 / wider batch per chip")
        return "HBM-bound: fuse more, keep activations bf16, bigger tiles"
    return ("collective-bound: overlap collectives with compute, reduce-"
            "scatter instead of all-reduce, or reshard to cut volume")


def _records(dryrun_dir: str):
    for f in sorted(os.listdir(dryrun_dir)):
        if f.endswith(".json") and f != "summary.json":
            with open(os.path.join(dryrun_dir, f)) as fh:
                yield f, json.load(fh)


def build_rows(dryrun_dir: str, mesh: str = "single", **hw):
    rows = []
    for f, r in _records(dryrun_dir):
        if not f.endswith(f"__{mesh}.json"):
            continue
        if r.get("status") == "skipped":
            rows.append((r, None))
        elif r.get("status") == "ok":
            rows.append((r, terms(r, **hw)))
    rows.sort(key=lambda rt: (rt[0]["arch"], ORDER.index(rt[0]["shape"])))
    return rows


def markdown(rows) -> str:
    out = [
        "| arch | shape | compute (ms) | memory (ms) | collective (ms) | "
        "dominant | MODEL/HLO flops | roofline frac | what moves it |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r, t in rows:
        if t is None:
            out.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | skipped | — | — | "
                f"{r['reason'][:60]}… |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']*1e3:.2f} | "
            f"{t['memory_s']*1e3:.2f} | {t['collective_s']*1e3:.2f} | "
            f"**{t['dominant']}** | {t['useful_ratio']:.2f} | "
            f"{t['roofline_frac']:.2%} | {remedy(r, t)} |")
    return "\n".join(out)


def dryrun_markdown(dryrun_dir: str) -> str:
    """The dry-run matrix: nothing compiles here, so the time column is
    the trace's, and temp is the op trace's eager estimate."""
    out = [
        "| arch | shape | mesh | layers | trace (s) | args/device (GiB) | "
        "temp/device est. (GiB) | collectives (AG/AR/RS/A2A) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    rows = [r for _, r in _records(dryrun_dir)]
    rows.sort(key=lambda r: (r["arch"], ORDER.index(r["shape"]),
                             r.get("mesh", "")))
    for r in rows:
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | "
                       f"{r.get('mesh', 'both')} | — | skipped | — | — | — |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | "
                       f"ERROR | — | — | — |")
            continue
        m = r["memory"]
        c = r["analysis"]["collective_counts"]
        cc = "/".join(str(c.get(k, 0)) for k in
                      ("all-gather", "all-reduce", "reduce-scatter",
                       "all-to-all"))
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['layers']} | "
            f"{r['lower_s']} | {m['argument_size_in_bytes'] / 2**30:.2f} | "
            f"{m['temp_size_in_bytes'] / 2**30:.2f} | {cc} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="results/dryrun_torch")
    ap.add_argument("--out", default="results/roofline_torch.md")
    args = ap.parse_args(argv)
    rows = build_rows(args.dryrun, "single")
    md = ["# Roofline (single pod, 16x16 = 256 H100s)", "",
          markdown(rows), "", "# Dry-run matrix", "",
          dryrun_markdown(args.dryrun)]
    text = "\n".join(md)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)
    print(text)


if __name__ == "__main__":
    main()
