"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

1. device: ``nvidia-smi`` name and power limit, torch's device name;
2. build: ``nvcc`` compiles the subround kernel for sm_90a from
   ``src/repro_torch/kernels/subround/kernel.cu``;
3. kernel against its plain version on the card, exactly, over 200 fuzz
   cases and the edge cases, then the time of one launch at the paper's
   shape (CUDA events over 1,000 launches) for both;
4. the main path at the paper's scale (``configs/orbitcache_paper.py``:
   10M keys, C = 128, 32 servers, 4M rps offered): preload the 128 hottest
   keys, run 1,000 windows through ``RackSimulator.run`` on the kernel,
   check that every subround launched the kernel once, then replay the same
   draws from the same carry with the plain version and require every carry
   leaf and every metric to be equal.

The line before the last two is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  There is no CPU fallback.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

WINDOWS = 1000
TIMED_LAUNCHES = 1000
FUZZ_CASES = 200
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
SCALAR_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores


def phase(name, **kv):
    print(json.dumps({"phase": name, **kv}), flush=True)


# --------------------------------------------------------------------------
# subround cases (numpy twin of the reference test suite's fuzz generator)
# --------------------------------------------------------------------------
def subround_case(seed, b, c, s, f, budget=None, fill=None, dead=False):
    """Random-but-consistent inputs of one subround, as numpy arrays in the
    kernel's argument order (hash words as int32 bit patterns)."""
    from repro_torch.core.hashing import hash128_u32_np
    rng = np.random.default_rng(seed)
    i32 = lambda a: np.asarray(a, np.int32)
    universe = int(rng.integers(c, 4 * c + 1))
    keys = rng.choice(2 * universe, c, replace=False).astype(np.int32)
    if rng.random() < 0.7:
        q = keys[rng.integers(0, max(1, c // 2), b)]
    else:
        q = rng.integers(0, 2 * universe, b).astype(np.int32)
    valid = rng.random(b) < rng.choice([0.0, 0.5, 0.9, 1.0])
    if dead:
        valid[:] = False
    op_class = rng.integers(0, 4, b)
    fill = fill or rng.choice(["empty", "random", "full"])
    qlen = {"empty": np.zeros(c), "full": np.full(c, s),
            "random": rng.integers(0, s + 1, c)}[fill]
    front = rng.integers(0, s, c)
    if budget is None:
        budget = int(rng.choice([0, 1, int(rng.integers(2, 10)), 10_000]))
    return [
        hash128_u32_np(q).view(np.int32),
        i32(valid & (op_class == 0)), i32(valid & (op_class == 1)),
        i32(valid & (op_class == 2)),
        i32(rng.integers(0, f + 1, b)), i32(rng.integers(1, f + 1, b)), q,
        i32(rng.integers(0, 1500, b)), i32(rng.integers(0, 8, b)),
        i32(rng.integers(0, 1 << 20, b)), i32(rng.integers(0, 100, b)),
        rng.random(b).astype(np.float32),
        hash128_u32_np(keys).view(np.int32),
        i32(rng.integers(0, 2, c)), i32(rng.integers(0, 2, c)),
        i32(rng.integers(0, 5, c)),
        i32(rng.integers(-1, 8, c * s)), i32(rng.integers(0, 99, c * s)),
        i32(rng.integers(0, 99, c * s)), rng.random(c * s).astype(np.float32),
        np.zeros(c * s, np.int32), i32(rng.integers(-1, 2000, c * s)),
        i32(qlen), i32(front), i32((front + qlen) % s),
        i32(rng.integers(0, 2, c * f)), i32(rng.integers(-1, 2000, c * f)),
        i32(rng.integers(0, 5, c * f)), i32(rng.integers(0, 1500, c * f)),
        i32(rng.integers(1, f + 1, c)), np.int32(budget),
    ]


# (b, c, s, f, j): the CPU tests' fuzz shapes, the kernel-test shapes, the
# paper's shape, and the shapes the kernel must take beyond it
FUZZ_SHAPES = ((32, 8, 4, 1, 4), (48, 16, 8, 2, 8))
PAPER = (352, 128, 8, 1, 8)
EXTRA_SHAPES = ((24, 8, 4, 1, 4), (64, 16, 8, 2, 8), (17, 5, 3, 2, 4),
                (300, 130, 8, 1, 8), PAPER, (4096, 128, 8, 1, 8),
                (64, 16, 8, 4, 8))


def check_kernel(dev):
    from repro_torch.kernels.subround.ops import SubroundOuts, subround
    from repro_torch.kernels.subround.ref import subround_ref

    cases = [(FUZZ_SHAPES[i % 2], dict(seed=1000 + i))
             for i in range(FUZZ_CASES)]
    for k, shp in enumerate(EXTRA_SHAPES):
        cases += [(shp, dict(seed=k)), (shp, dict(seed=k, budget=0)),
                  (shp, dict(seed=k, fill="full", budget=3)),
                  (shp, dict(seed=k, dead=True))]
    max_err = 0.0
    for (b, c, s, f, j), kw in cases:
        args = [torch.from_numpy(np.array(a)).to(dev)
                for a in subround_case(b=b, c=c, s=s, f=f, **kw)]
        got = subround(*args, s, f, j)
        want = subround_ref(*args, queue_size=s, max_frags=f, max_serves=j)
        torch.cuda.synchronize()
        for name, g, w in zip(SubroundOuts._fields, got, want):
            if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError(f"kernel != plain version at {name} "
                                     f"(b={b} c={c} s={s} f={f} j={j} {kw})")
            err = (g.double() - w.double()).abs().max().item() if g.numel() else 0
            max_err = max(max_err, err)
    return len(cases), max_err


def time_kernel(dev):
    """ms per launch at the paper's shape: the kernel alone (direct
    launches), the wrapper the main path calls, and the plain version."""
    from repro_torch.kernels.subround import kernel
    from repro_torch.kernels.subround.ops import SubroundOuts, subround
    from repro_torch.kernels.subround.ref import subround_ref

    b, c, s, f, j = PAPER
    args = [torch.from_numpy(np.array(a)).to(dev)
            for a in subround_case(7, b, c, s, f, budget=1000)]
    outs = subround(*args, s, f, j)
    ptrs = ([a.data_ptr() for a in args[:-1]]
            + [args[-1].reshape(1).data_ptr()] + [o.data_ptr() for o in outs])
    stream = torch.cuda.current_stream(dev).cuda_stream

    def timed(fn, n=TIMED_LAUNCHES):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(n):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / n

    ms = timed(lambda: kernel.launch(ptrs, b, c, s, f, j, stream))
    # an empty kernel, launched the same way: the floor launching sets
    launch_floor_ms = timed(lambda: kernel.launch(ptrs, b, c, s, f, j, stream,
                                                  empty=True))
    wrapper_ms = timed(lambda: subround(*args, s, f, j))
    plain_ms = timed(lambda: subround_ref(*args, queue_size=s, max_frags=f,
                                          max_serves=j))
    # least time: every input read once and every output written once over
    # HBM, against the match's B*C*5 32-bit operations over the scalar rate
    nbytes = (sum(a.numel() * a.element_size() for a in args)
              + sum(o.numel() * o.element_size() for o in outs))
    ops = b * c * 5
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    assert len(outs) == len(SubroundOuts._fields)
    return dict(ms=ms, launch_floor_ms=launch_floor_ms,
                wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------
# main path
# --------------------------------------------------------------------------
def clone_tree(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone_tree(v) for v in x))
    return x


def run_main_path(dev):
    from repro_torch import kernels as kn
    from repro_torch.configs.orbitcache_paper import RACK, WORKLOAD
    from repro_torch.interop import to_numpy
    from repro_torch.kernels.subround import ref as ref_mod
    from repro_torch.kvstore.simulator import RackSimulator
    from repro_torch.kvstore.workload import Workload

    t0 = time.perf_counter()
    wl = Workload(WORKLOAD, device=dev)
    sim = RackSimulator(RACK, wl)
    torch.cuda.synchronize()
    phase("setup", seconds=round(time.perf_counter() - t0, 3),
          num_keys=WORKLOAD.num_keys, cache_entries=RACK.cache_entries,
          num_servers=RACK.num_servers, client_batch=RACK.client_batch,
          value_pad=RACK.value_pad, offered_rps=WORKLOAD.offered_rps,
          device_mib=round(torch.cuda.memory_allocated(dev) / 2**20, 1))
    sim.preload(wl.hottest_keys(RACK.cache_entries))
    start = clone_tree(sim.carry)
    gen_state = sim.carry.draws.get_state()

    ref_calls = [0]
    real_ref = ref_mod.subround_ref

    def counting_ref(*a, **k):
        ref_calls[0] += 1
        return real_ref(*a, **k)

    ref_mod.subround_ref = counting_ref
    seconds = WINDOWS * RACK.window_us * 1e-6
    try:
        kn.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sim.run(seconds, chunk_windows=WINDOWS // 4)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kn.LAUNCHES["subround"]
        n_win = len(res.traces["tx"])
        if n_win != WINDOWS or launches != RACK.subrounds * WINDOWS:
            raise AssertionError(f"{launches} subround launches in {n_win} "
                                 f"windows; want {RACK.subrounds} per window")
        if ref_calls[0]:
            raise AssertionError(f"the plain subround ran {ref_calls[0]} "
                                 f"times on the kernel path")
        cuda_carry = to_numpy(sim.carry)
        rx_sw = res.traces["rx_switch"].astype(np.int64).sum()
        rx_srv = res.traces["rx_server"].astype(np.int64).sum()
        phase("main_path", windows=n_win, seconds=round(wall, 3),
              windows_per_s=round(n_win / wall, 1),
              throughput_rps=res.throughput_rps(),
              offered_rps=res.offered_rps(),
              switch_share=float(rx_sw / max(rx_sw + rx_srv, 1)),
              balancing_efficiency=res.balancing_efficiency(),
              p50_us=res.latency_percentile(0.5),
              p99_us=res.latency_percentile(0.99),
              subround_launches=launches,
              peak_device_mib=round(torch.cuda.max_memory_allocated(dev)
                                    / 2**20, 1))
        if not res.throughput_rps() > 0 or not rx_sw > 0:
            raise AssertionError("the rack served nothing")

        # the same draws from the same carry, through the plain version
        sim.carry = clone_tree(start)
        sim.carry.draws.set_state(gen_state)
        kn.set_kernel_backend("ref")
        try:
            t0 = time.perf_counter()
            res_ref = sim.run(seconds, chunk_windows=WINDOWS // 4)
            torch.cuda.synchronize()
            wall_ref = time.perf_counter() - t0
        finally:
            kn.set_kernel_backend(None)
        if ref_calls[0] != RACK.subrounds * WINDOWS:
            raise AssertionError(f"plain replay ran {ref_calls[0]} subrounds")
        for k, v in res.traces.items():
            if not np.array_equal(v, res_ref.traces[k]):
                raise AssertionError(f"replay differs in metric {k}")
        ref_carry = to_numpy(sim.carry)
        n_leaves = compare_trees(cuda_carry, ref_carry, "carry")
        phase("replay_plain", windows=len(res_ref.traces["tx"]),
              seconds=round(wall_ref, 3), equal_leaves=n_leaves,
              equal_metrics=len(res.traces))

        # what the profiler sees of a short run of the kernel path
        sim.carry = clone_tree(start)
        sim.carry.draws.set_state(gen_state)
        kn.reset_launch_counts()
        prof_windows = 25
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            sim.run_windows(prof_windows)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        ka = prof.key_averages()
        dev_events = [e for e in ka if getattr(e, "device_type", None)
                      == torch.autograd.DeviceType.CUDA]
        sub = sum(e.count for e in dev_events if "subround_kernel" in e.key)
        if not dev_events:
            raise AssertionError("the profiler saw no device events")
        if sub != RACK.subrounds * prof_windows:
            raise AssertionError(f"profiler saw {sub} subround kernels in "
                                 f"{prof_windows} windows")
        dev_us = sum(getattr(e, "self_device_time_total", 0)
                     for e in dev_events)
        busy_ms_per_window = dev_us / 1e3 / prof_windows
        # the device's idle share of the unprofiled main-path run, from the
        # device time per window the profiler saw; and of the profiled
        # window itself, whose wall time includes the profiler's overhead
        phase("profile", windows=prof_windows, subround_kernels=sub,
              launch_count=kn.LAUNCHES["subround"],
              device_kernels=sum(e.count for e in dev_events),
              device_busy_ms_per_window=busy_ms_per_window,
              wall_ms_per_window=wall * 1e3 / n_win,
              profiled_wall_ms_per_window=prof_wall * 1e3 / prof_windows,
              device_idle_share=1 - busy_ms_per_window / (wall * 1e3 / n_win),
              device_idle_share_profiled=1 - dev_us / 1e6 / prof_wall)
    finally:
        ref_mod.subround_ref = real_ref
    return launches


def compare_trees(a, b, path):
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return sum(compare_trees(x, y, f"{path}.{n}")
                   for n, x, y in zip(a._fields, a, b))
    if isinstance(a, np.ndarray):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"replay differs at {path}")
        return 1
    return 0


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "smoke run needs a CUDA card")
    from repro_torch.kernels.subround import kernel

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    phase("device", nvidia_smi=smi, torch_device=name,
          torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    lib, log = kernel.build(verbose=True)
    kernel.library()
    phase("build", seconds=round(time.perf_counter() - t0, 2),
          library=os.path.relpath(lib, HERE),
          ptxas=[ln.strip() for ln in log.splitlines() if "ptxas" in ln])

    n_cases, max_err = check_kernel(dev)
    timing = time_kernel(dev)
    phase("kernel_vs_plain", cases=n_cases, equal=True, max_abs_err=max_err,
          **timing)

    launches = run_main_path(dev)

    print(json.dumps({"kernels": [{
        "name": "subround", "route": "cuda",
        "source": "src/repro_torch/kernels/subround/kernel.cu",
        "replaces": "src/repro/kernels/subround/kernel.py:32",
        "launches": launches, "max_abs_err": max_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
