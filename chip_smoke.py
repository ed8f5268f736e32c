"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py
    python3 chip_smoke.py --against DIR

``--against DIR`` only times the four kernels built from
``DIR/{subround,cms,hot_gather,orbit_match}.cu`` (another version of each,
such as a parent commit's, extracted with ``git show``) against the
tree's, in turns, each first held against its plain version (``hot_gather``
also on the inputs of one control-plane period), and prints no result
line.  With no argument, the phases, each printed on its own
line; any failure exits non-zero:

1. device: ``nvidia-smi`` name and power limit, torch's device name;
2. build: ``nvcc`` compiles the four kernels for sm_90a, one process per
   source, all started together (``kernels/{subround,cms,hot_gather,
   orbit_match}/kernel.cu``), and prints ``ptxas``'s report for each;
3. each kernel against its plain version on the card over fuzz cases,
   the shapes of the paper's rack and cases aimed at its design (exactly;
   bf16 ``hot_gather`` rows within rtol = atol = 2e-2, float32 rows with
   several matches a lane within 1e-6), then its times: ``device_us``, the
   device
   time per launch (1,000 launches captured in a CUDA graph, replays timed
   with CUDA events) and ``device_floor_us``, an empty kernel with the same
   grid timed the same way; ``ms``, CUDA events around 1,000 direct
   launches, and ``host_issue_ms``, the empty kernel read that way (the
   host's cost of issuing a call, which ``ms`` reads wherever the kernel is
   faster than it); the wrapper's and the plain version's ms; for
   ``hot_gather``, the library's two calls beside it, read both ways;
4. main path at the paper's scale (``configs/orbitcache_paper.py``: 10M
   keys, C = 128, 32 servers, 4M rps offered): preload the 128 hottest
   keys, run 1,000 windows through ``RackSimulator.run``, each window a
   replay of a CUDA graph (the simulator's default on the card), check
   that every subround launched the kernel once; then the first 250
   windows again, graphed and as eager chunks on the kernel path
   (``graphs=False``), equal in every carry leaf and metric, and the
   same 250 windows replayed with the plain version (eager chunks), equal
   in every carry leaf and metric to the graphed run, and 10
   windows profiled each way (``graphed_vs_eager``: windows/s, device ms
   per window and the device's idle share of each run, the graphs'
   capture seconds and pool memory; where the profiler sees no kernel of
   a replayed graph, the device time comes from CUDA events around the
   replays and ``device_time_method`` says so);
5. control plane at the same scale with the servers' popularity tracking
   on: preload, then three phases of ``run(0.05, controller_period_s=
   0.01)`` (500 windows, 5 periods each) with ``hot_in_swap(128)`` before
   phases 2 and 3, the cadence of Fig. 18, graphed (a window graph and a
   period graph).  Every window must launch 4 subround kernels and 1
   count-min kernel, every period 3 hot_gather kernels, and no plain
   version may run; the three phases cut to 100 windows (1 period)
   each, with both swaps, graphed and as eager chunks on the kernel path,
   must be equal (``graphed_vs_eager``, a period of 10 windows profiled
   each way), and so must their replay under the plain versions.  Then
   one period from the start again (eager), recording the three input sets of its ``_merge_scores`` call;
   each is held against the plain version and timed
   (``hot_gather_live``);
6. ``orbit_match``, which no simulator path calls, through its own entry
   point ``kernels.orbit_match``: against its plain version over fuzz
   cases and on the paper rack's table after the preload against one
   window's live ingress, timed there, then one call per subround of that
   window with the launches counted;
7. the compared schemes on the paper rack: NoCache, and NetCache with the
   10,000 hottest keys preloaded, 500 graphed windows each
   (``serve_kv.py``'s 0.05 s); neither may launch a kernel or run a plain
   version; their first 100 windows graphed and as eager chunks must be
   equal (``graphed_vs_eager``).  Then 64 windows of each from one carry and
   one set of numpy-made draws, once on the card and once on the CPU:
   every carry leaf and metric equal;
8. ``no_sync``, after each of the cells above: 8 windows (a period on the
   control plane) as an eager chunk and as graph replays, each under
   ``torch.cuda.set_sync_debug_mode("error")``;
9. the batched kernels of the fleet (``kvstore/fleet.py``), each against
   its plain version once per point over fuzz cases, shared inputs
   included (``*_batched_vs_plain``), and timed at P = 1, 4 and 12 points
   a launch beside P x the single launch's device time;
10. ``fleet_staircase``: ``BatchedRackSimulator`` with 12 OrbitCache
   points at 0.5 ... 6.0 M rps (seeds 0-11, every workload leaf
   shared), preloaded, ``reset_stats``, ``run(0.03)``
   (``knee_throughput_parallel``'s run: 256 windows, the reference's
   chunk rule), 4 subround launches a fleet window for all points; each
   point equal to a serial graphed rack of its seed and load in every
   carry leaf and metric; per point rx, loss, worst server's drop share,
   p99 and the knee; 16 windows from the same start graphed, eager and
   under the plain versions, all equal; ``no_sync``;
11. ``fleet_control_plane``: 4 seeds with tracking on, the three phases
   of phase 5 with ``refresh_workloads`` after each swap; per fleet window
   4 subround and 1 count-min launch, per period 3 hot_gather launches;
   each point equal to the serial control-plane rack of its seed in every
   carry leaf, metric, period update and ``active_size``; one period
   graphed, eager and under the plain versions, equal; ``no_sync``;
12. ``fleet_skew``: Zipf 0.9, 0.95 and 0.99 (the CDF stacked, each
   point's hot set) for OrbitCache, NetCache (each point's 10,000 hottest
   keys) and NoCache, ``run(0.03)`` each, every point equal to its serial
   rack and its post-window invariants holding against its preload
   (``analysis.invariants``); NetCache and NoCache launch no kernel;
13. the fabric's kernel launches (``fabric_batched_vs_plain``):
   ``subround`` and ``cms`` under two vmap levels (3 points x 4 racks at
   the paper fabric rack's shapes, inputs batched at both levels or the
   tables shared over the racks and expanded), ``subround`` at 3 spines
   of 256 entries, each one launch and equal to its plain version per
   point, timed beside P x the single launch; the spine controller's
   ``hot_gather`` shapes, timed;
14. ``fabric_paper``: ``FabricSimulator`` with 4 paper racks (tracking
   on) under the default ``FabricConfig`` (locality 0.9, an OrbitCache
   spine of 256 entries): preload, ``run(0.05, controller_period_s=
   0.01)`` graphed, 8 ``subround`` and 1 ``cms`` launches a fabric window
   and 6 ``hot_gather`` a period, no plain version; the spine's
   conservation law; the post-window invariants of every rack and the
   spine; the spine controller's three ``_merge_scores``
   input sets of its first period against the plain version and timed
   (``hot_gather_spine_live``); the same fabric without the servers'
   tracking at locality 1.0, 64 windows from its preload, rack i equal to
   the serial paper rack of seed i (``fabric_locality_one``); one period
   of 25 windows graphed, eager and under the plain versions, equal
   (``fabric_replays``); 10 windows profiled graphed and eager;
   ``no_sync``;
15. ``fabric_locality``: ``BatchedFabricSimulator`` at
   ``benchmarks/fabric_locality.py``'s full settings (4 racks of C = 64,
   8 servers, a 256-lane batch, 2 subrounds; 1M keys at 1.0M rps;
   localities 1.0 / 0.9 / 0.5 as 3 points) for each scheme at both
   tiers: preload with 16 warm windows, 256 windows, the benchmark's
   columns per point, 4 ``subround`` launches a batched window for
   OrbitCache and none for the others, each point equal to a serial
   graphed fabric of its seed and locality, ``no_sync``; then OrbitCache
   with tracking on, one period of 16 windows: 1 ``cms`` a window and 6
   ``hot_gather``, graphed = eager = plain.
16. ``composed_vs_fused``: on the paper rack at 10 % writes, for
   OrbitCache, NetCache and NoCache, 24 windows after the preload from one
   carry and one set of draws through the fused ``window_step`` (one
   ``subround`` launch a subround) and through the composed window of
   ``tests/torch_composed.py`` (``lookup``, ``request_table``,
   ``state_table``, ``orbit``; plain PyTorch on the card): every metric
   and carry leaf equal, each window; then ``switch_step`` against the
   composed seed step on the four edge cases (zero budget, full queues,
   multi-fragment lines, all-invalid ingress), 17 steps; no plain version
   runs, and only OrbitCache's fused side launches (96 + 17 ``subround``);
17. ``ring_stacked``: ``StackedRing(8)`` from the start of
   ``tests/test_distributed_ring.py`` over a revolution, equal on the
   card and on the CPU leaf for leaf; every request served once with its
   entry's bytes, the queues drained; no kernel launched;
18. ``orbit_service``: 8 stacked positions, ``ServiceConfig`` defaults,
   the paper's 10M keys (a 2.4 GiB store of 256-B values on the card,
   value = ``synth_value(key, 0)``), the 64 hottest keys installed as
   orbit lines, 200 steps of Zipf-0.99 lookups (the workload's CDF) timed,
   then 16 steps with no lookups: cold values byte exact, every hot lookup
   served exactly once with its key's bytes and the queues empty, the
   first 4 steps equal to a CPU run; steps/s, lookups/s, the hot, cold
   and unanswered shares beside the ``nvidia-smi`` line;
19. ``ring_process``: a one-rank ``nccl`` ``ProcessRing`` (a barrier
   first), equal to ``StackedRing(1)`` leaf for leaf over 16 service
   steps.  Rings of D > 1 processes are checked with gloo on the CPU only
   (``tests/test_torch_distributed_ring.py``,
   ``tests/test_torch_orbit_service.py``);
20. ``analysis`` (``src/repro_torch/analysis/``): the lint, all six rules
   over all six entry points on the kernel backend (0 findings: launches
   equal to the dispatcher calls and to the profiler's kernels, no copy
   in a replayed chunk, no recapture over a sweep), and every rule's
   seeded violation firing and its clean twin passing on the card; the
   main path's workload through the paper rack graphed: one replayed
   window under ``torch.profiler`` (4 ``subround_kernel`` equal to
   ``LAUNCHES``, 0 HtoD and 0 DtoH copies), then ``test_invariants.py``'s
   staircase (4 chunks of 4 windows at 0.3-2.5x the offered load and
   write ratios 0-0.4): the post-window invariants against the chunk
   before, the carry in the chunk's buffers, no memory growth after chunk
   2, no new capture; the invariants over 3 control-plane periods of 10
   windows with two ``hot_in_swap(128)``, and over 3 NetCache chunks (the
   10,000 hottest keys); with the checks of phases 12 and 14.

Every phase line carries ``t_s``, the seconds since the script started.
The line before the last two is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  There is no CPU fallback.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, os.path.join(HERE, "tests"))     # torch_composed.py

import numpy as np  # noqa: E402
import torch  # noqa: E402

WINDOWS = 1000
TIMED_LAUNCHES = 1000
FUZZ_CASES = 200
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
SCALAR_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
CP_PHASES, CP_PHASE_S, CP_PERIOD_S, CP_SWAP = 3, 0.05, 0.01, 128
# depth of the graphed-against-eager comparison and the plain replays,
# cut to keep the script's time: the main path's first 250 windows, the
# control plane's three phases and two swaps at 100 windows (1 period) a
# phase
EAGER_WINDOWS, CP_EAGER_S = 250, 0.01
SCHEME_S, SCHEME_CHECK_WINDOWS = 0.05, 64
# windows profiled eager and graphed (each window is 700-2,800 device
# kernels, and the profiler's processing of the events grows with them),
# the control plane's with a period of PROFILE_WINDOWS; the schemes'
# graphed-against-eager comparison over their first 100 windows
PROFILE_WINDOWS, SCHEME_EAGER_S = 10, 0.01
BF16_TOL = 2e-2               # tests/test_kernels.py's bf16 hot_gather bound


T0 = time.perf_counter()


def phase(name, **kv):
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": name, **kv,
                      "t_s": round(time.perf_counter() - T0, 1)}),
          flush=True)


def timed(fn, n=TIMED_LAUNCHES):
    """ms per call of ``fn``: CUDA events around ``n`` calls, after a
    warm-up.  For a kernel launched through ``ctypes`` this reads the
    slower of the host's cost of issuing a call and the device's time per
    kernel: see :func:`device_timed` for the device alone."""
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


def device_timed(launch, n=TIMED_LAUNCHES, replays=5):
    """``(µs per launch on the device, method)`` for ``launch(stream)``,
    which issues one launch (with any stream operation it needs, such as a
    memset) on the stream it is given, with fixed pointers.

    ``n`` launches are captured in a CUDA graph and replays of it are timed
    with CUDA events, so the host's issue cost is out of the reading.  If
    the capture fails, ``self_device_time_total`` of the device events that
    ``torch.profiler`` sees over ``n`` direct launches, over ``n``."""
    stream = torch.cuda.current_stream()
    for _ in range(20):
        launch(stream.cuda_stream)
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            cap = torch.cuda.current_stream().cuda_stream
            for _ in range(n):
                launch(cap)
        graph.replay()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(replays):
            graph.replay()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) * 1e3 / (replays * n), "cuda_graph"
    except RuntimeError as err:
        phase("device_timed_fallback", reason=str(err)[:200])
        torch.cuda.synchronize()
    events, _ = device_profile(
        lambda: [launch(stream.cuda_stream) for _ in range(n)])
    return device_us(events) / n, "profiler"


def kernel_times(launch, empty, wrapper, plain):
    """The timings every kernel reports, ``launch(stream)`` and
    ``empty(stream)`` issuing one launch of the kernel and of the empty
    kernel with the same grid and shared memory: ``device_us`` and
    ``device_floor_us`` (device alone, :func:`device_timed`), and ``ms``
    and ``host_issue_ms`` (CUDA events around back-to-back direct
    launches, which read the host's issue cost per call wherever it
    exceeds the device time), the wrapper's and the plain version's ms."""
    stream = torch.cuda.current_stream().cuda_stream
    dev_us, method = device_timed(launch)
    floor_us, _ = device_timed(empty)
    return dict(device_us=dev_us, device_floor_us=floor_us,
                device_timing=method, ms=timed(lambda: launch(stream)),
                host_issue_ms=timed(lambda: empty(stream)),
                wrapper_ms=timed(wrapper), plain_ms=timed(plain))


def bound(nbytes, ops):
    """The least time (ms): bytes over HBM against operations over the
    scalar rate, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return dict(bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def device_profile(fn, require=True):
    """Run ``fn`` under ``torch.profiler``: ``(device events, wall s)``.
    Fails if the profiler saw no device event, unless not ``require``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA]
    if not events and require:
        raise AssertionError("the profiler saw no device events")
    return events, wall


def device_us(events, name=""):
    """Device µs of the events whose key holds ``name``."""
    return sum(getattr(e, "self_device_time_total", 0) for e in events
               if name in e.key)


def busy_per_window(run, n_windows, events=None, wall=None):
    """Device time of ``run()``, which steps ``n_windows`` windows (or of
    the profiler's ``events`` over ``wall`` s of such a run, if given).
    From ``torch.profiler``'s device events; where it sees none (kernels
    inside a replayed CUDA graph may stay hidden from it), from CUDA
    events around the run, which also count the device's idle gaps, and
    no kernel count."""
    if events is None:
        events, wall = device_profile(run, require=False)
    if events:
        ms = device_us(events) / 1e3 / n_windows
        kernels, method = sum(e.count for e in events) / n_windows, \
            "profiler"
    else:
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        run()
        t1.record()
        torch.cuda.synchronize()
        ms, kernels, method = t0.elapsed_time(t1) / n_windows, None, \
            "cuda_events"
    return dict(device_ms_per_window=ms, device_kernels_per_window=kernels,
                device_time_method=method,
                profiled_wall_ms_per_window=wall * 1e3 / n_windows)


def rates(n_win, wall, busy):
    """windows/s and wall ms per window of an unprofiled run of ``n_win``
    windows in ``wall`` s, with ``busy`` (:func:`busy_per_window` of a
    profiled stretch of the same mode) and the device's idle share against
    the unprofiled window and against the profiled one.  The profiler
    lengthens each kernel it records a little, so against a graphed
    window, which the device's time alone sets, the first can fall below
    0."""
    wall_ms = wall * 1e3 / n_win
    ms = busy["device_ms_per_window"]
    return dict(windows_per_s=round(n_win / wall, 1), seconds=round(wall, 3),
                wall_ms_per_window=wall_ms, **busy,
                device_idle_share=1 - ms / wall_ms,
                device_idle_share_profiled=(
                    1 - ms / busy["profiled_wall_ms_per_window"]))


def graphed_and_eager(cell, sim, drive, rewind):
    """``drive()`` from ``rewind()`` as graphed chunks, then again from
    ``rewind()`` as eager chunks on the kernel path (``graphs=False``):
    every output (``drive`` returns a list of dicts of numpy arrays) and
    every carry leaf must be equal.  Returns ``(graphed wall s, eager wall
    s, equal leaves, equal outputs, (graphed outputs, graphed carry))``."""
    from repro_torch.interop import to_numpy

    runs = []
    for graphs in (True, False):
        rewind()
        sim.chunk.graphs = graphs
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = drive()
            torch.cuda.synchronize()
            runs.append((out, time.perf_counter() - t0, to_numpy(sim.carry)))
        finally:
            sim.chunk.graphs = True
    (got, wall_g, carry_g), (want, wall_e, carry_e) = runs
    n_out = 0
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        for k, v in g.items():
            if v.dtype != w[k].dtype or not np.array_equal(v, w[k]):
                raise AssertionError(f"{cell}: graphed and eager chunks "
                                     f"differ in output {i} {k}")
            n_out += 1
    n_leaves = compare_trees(carry_g, carry_e, f"{cell} carry")
    return wall_g, wall_e, n_leaves, n_out, (got, carry_g)


def plain_replay(cell, sim, drive, rewind, graphed):
    """``drive()`` from ``rewind()`` under the plain versions (eager
    chunks, so that every plain call is counted): every output and carry
    leaf must equal ``graphed`` (the kernel run's ``(outputs, carry)``).
    Returns ``(wall s, equal leaves, equal outputs)``."""
    from repro_torch import kernels as kn
    from repro_torch.interop import to_numpy

    rewind()
    kn.set_kernel_backend("ref")
    sim.chunk.graphs = False
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = drive()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        kn.set_kernel_backend(None)
        sim.chunk.graphs = True
    n_out = 0
    for i, (g, w) in enumerate(zip(graphed[0], out, strict=True)):
        for k, v in g.items():
            if v.dtype != w[k].dtype or not np.array_equal(v, w[k]):
                raise AssertionError(f"{cell}: the plain replay differs in "
                                     f"output {i} {k}")
            n_out += 1
    return wall, compare_trees(graphed[1], to_numpy(sim.carry),
                               f"{cell} replay carry"), n_out


def graph_stats(sim):
    ch = sim.chunk
    return dict(capture_seconds=round(ch.capture_seconds, 3),
                captures=ch.captures,
                graph_pool_mib={k: round(v / 2**20, 1)
                                for k, v in ch.graph_bytes.items()})


def no_sync(cell, sim, period_w=None):
    """8 windows (with ``period_w``, one period) of ``sim``'s chunk, eager
    then graphed, each under ``torch.cuda.set_sync_debug_mode("error")``
    after one unchecked run (which captures the graphs): no window or
    period boundary may wait for the card or copy from the host."""
    wl = sim.wl.arrays

    def run():
        if period_w:
            sim.chunk.controller_chunk(wl, sim.carry,
                                       sim.controller.active_size,
                                       sim.controller.cfg, 1, period_w)
        else:
            sim.chunk(wl, sim.carry, 8)

    for graphs in (False, True):
        sim.chunk.graphs = graphs
        run()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    phase("no_sync", cell=cell, windows=period_w or 8,
          period=bool(period_w), eager=True, graphed=True)


def max_abs_err(got, want):
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    if not got.numel():
        return 0.0
    return (got.double() - want.double()).abs().max().item()


# --------------------------------------------------------------------------
# subround cases (numpy twin of the reference test suite's fuzz generator)
# --------------------------------------------------------------------------
def subround_case(seed, b, c, s, f, budget=None, fill=None, dead=False,
                  one_key=False, dup=False):
    """Random-but-consistent inputs of one subround, as numpy arrays in the
    kernel's argument order (hash words as int32 bit patterns).
    ``one_key``: every lane wants entry 0, valid and occupied, so one
    entry's admission runs across every warp of the block; ``dup``: a
    quarter of the entries copy the key of another, all occupied, so that
    ``pop`` counts both and ``cidx`` takes the first."""
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
    args = [
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
    hk, want, thk, occ, stv = (args[i] for i in (0, 1, 12, 13, 14))
    if dup:
        n = max(1, c // 4)
        src, dst = rng.integers(0, c, n), rng.integers(0, c, n)
        thk[dst] = thk[src]
        occ[src], occ[dst] = 1, 1
    if one_key:
        hk[:] = thk[0]
        want[:] = 1
        occ[0], stv[0] = 1, 1
    return args


# (b, c, s, f, j): the CPU tests' fuzz shapes, the kernel-test shapes, the
# paper's shape, and the shapes the kernel must take beyond it
FUZZ_SHAPES = ((32, 8, 4, 1, 4), (48, 16, 8, 2, 8))
PAPER = (352, 128, 8, 1, 8)
EXTRA_SHAPES = ((24, 8, 4, 1, 4), (64, 16, 8, 2, 8), (17, 5, 3, 2, 4),
                (300, 130, 8, 1, 8), PAPER, (4096, 128, 8, 1, 8),
                (64, 16, 8, 4, 8), (33, 8, 4, 1, 4), (1000, 128, 8, 1, 8))
# the cases aimed at the kernel's parallel admission and its match: one
# entry wanted across every warp (and, past 512 lanes, every round of the
# block), and duplicate occupied entries
TARGETED_SHAPES = ((33, 8, 4, 1, 4), (64, 16, 8, 4, 8), PAPER,
                   (1000, 128, 8, 1, 8), (4096, 128, 8, 1, 8))


def check_kernel(dev):
    from repro_torch.kernels.subround.ops import SubroundOuts, subround
    from repro_torch.kernels.subround.ref import subround_ref

    cases = [(FUZZ_SHAPES[i % 2], dict(seed=1000 + i))
             for i in range(FUZZ_CASES)]
    for k, shp in enumerate(EXTRA_SHAPES):
        cases += [(shp, dict(seed=k)), (shp, dict(seed=k, budget=0)),
                  (shp, dict(seed=k, fill="full", budget=3)),
                  (shp, dict(seed=k, dead=True))]
    for k, shp in enumerate(TARGETED_SHAPES):
        cases += [(shp, dict(seed=50 + k, one_key=True, fill="empty",
                             budget=10_000)),
                  (shp, dict(seed=50 + k, one_key=True)),
                  (shp, dict(seed=50 + k, dup=True)),
                  (shp, dict(seed=60 + k, dup=True, one_key=True))]
    max_err = 0.0
    for (b, c, s, f, j), kw in cases:
        args = [torch.from_numpy(np.array(a)).to(dev)
                for a in subround_case(b=b, c=c, s=s, f=f, **kw)]
        got = subround(*args, s, f, j)
        want = subround_ref(*args, queue_size=s, max_frags=f, max_serves=j)
        torch.cuda.synchronize()
        for name, g, w in zip(SubroundOuts._fields, got, want):
            max_err = max(max_err, max_abs_err(g, w))
            if not torch.equal(g, w):
                raise AssertionError(f"kernel != plain version at {name} "
                                     f"(b={b} c={c} s={s} f={f} j={j} {kw})")
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
    times = kernel_times(
        lambda st: kernel.launch(ptrs, b, c, s, f, j, st),
        lambda st: kernel.launch(ptrs, b, c, s, f, j, st, empty=True),
        lambda: subround(*args, s, f, j),
        lambda: subround_ref(*args, queue_size=s, max_frags=f, max_serves=j))
    # least time: every input read once and every output written once over
    # HBM, against the match's B*C*5 32-bit operations over the scalar rate
    nbytes = (sum(a.numel() * a.element_size() for a in args)
              + sum(o.numel() * o.element_size() for o in outs))
    assert len(outs) == len(SubroundOuts._fields)
    return dict(**times, **bound(nbytes, b * c * 5))


# --------------------------------------------------------------------------
# count-min kernel
# --------------------------------------------------------------------------
# the rack's shape: 32 sketches of [5, 2048] over the window's 1,408 lanes
# (768 client + 64 correction + 320 reply + 256 fetch)
CMS_PAPER = (32, 1408, 2048)


def cms_case(seed, n, b, w, density, dev, pattern=None, tile=None):
    """(idx, mask, counts) on ``dev``: repeated keys, per-sketch masks
    and a nonzero starting sketch; ``n`` None means one sketch.
    ``pattern`` replaces the random mask: "tile_end" masks one lane, the
    last of the second tile (of the first where there is one), and
    "one_tile" masks every lane of that tile and no other."""
    from repro_torch.core.hashing import hash128_u32_np
    from repro_torch.kernels.cms.ops import rows_for
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2 * b + 4, b).astype(np.int32)
    lead = () if n is None else (n,)
    hk = torch.from_numpy(hash128_u32_np(keys).view(np.int32)).to(dev)
    mask = torch.from_numpy((rng.random(lead + (b,)) < density)
                            .astype(np.int32)).to(dev)
    counts = torch.from_numpy(rng.integers(0, 51, lead + (5, w))
                              .astype(np.int32)).to(dev)
    if pattern is not None:
        t0 = tile if b > tile else 0
        t1 = min(t0 + tile, b)
        mask.zero_()
        if pattern == "tile_end":
            mask[..., t1 - 1] = 1
        else:
            mask[..., t0:t1] = 1
    return rows_for(hk, w), mask, counts


def check_cms(dev):
    from repro_torch.kernels.cms.ops import tile_for, update_query
    from repro_torch.kernels.cms.ref import cms_update_query_fast

    cases = [(n, b, w, p, blk)
             for n in (None, 4) for b in (1, 7, 8, 45, 256, 257, 600)
             for w in (64, 512, 2048) for p in (0.0, 0.5, 1.0)
             for blk in (32, 256)]
    n, b, w = CMS_PAPER
    cases += [(n, b, w, p, 256) for p in (1 / 32, 0.5, 1.0)]
    # aimed at the kernel's list of masked lanes and its vector copies:
    # widths not a multiple of 4 (and 1,000, whose sketch rows are), one
    # lane past the rack's batch, one masked lane at the end of a tile,
    # one tile wholly masked and the others not
    cases += [(n, b, w, p, blk) for n in (None, 32) for b in (257, 1409)
              for w in (1000, 2047) for p in (1 / 32, 1.0)
              for blk in (32, 256)]
    cases += [(n, 1409, 2048, p, 256) for n in (None, 32)
              for p in (1 / 32, 0.5)]
    cases += [(n, b, w, pat, blk) for pat in ("tile_end", "one_tile")
              for n in (None, 4) for b in (7, 600, 1409)
              for w in (64, 2047) for blk in (32, 256)]
    # tiles longer than the kernel's list (queried, then updated, unit by
    # unit): past 4,096 lanes, and beside a sketch that leaves room for
    # 512 lanes only
    cases += [(None, 5000, 64, 0.5, 5000), (2, 1000, 10500, 0.5, 1000),
              (2, 1000, 10500, 0.5, 256)]
    max_err = 0.0
    for i, (n, b, w, p, blk) in enumerate(cases):
        tile = tile_for(b, blk)
        pat = p if isinstance(p, str) else None
        idx, mask, counts = cms_case(i, n, b, w, 0.0 if pat else p, dev,
                                     pattern=pat, tile=tile)
        got = update_query(idx, mask, counts, tile)
        want = cms_update_query_fast(idx, mask, counts, block_b=tile)
        torch.cuda.synchronize()
        for name, g, wt in zip(("counts", "est"), got, want):
            max_err = max(max_err, max_abs_err(g, wt))
            if not torch.equal(g, wt):
                raise AssertionError(f"cms kernel != plain version at {name} "
                                     f"(n={n} b={b} w={w} p={p} blk={blk})")
    return len(cases), max_err


def time_cms(dev):
    """ms per launch at the rack's shape, with each server's mask the
    share of lanes it receives (1/32)."""
    from repro_torch.kernels.cms import kernel
    from repro_torch.kernels.cms.ops import tile_for, update_query
    from repro_torch.kernels.cms.ref import cms_update_query_fast

    n, b, w = CMS_PAPER
    idx, mask, counts = cms_case(7, n, b, w, 1 / 32, dev)
    tile = tile_for(b)
    out, est = update_query(idx, mask, counts, tile)
    ptrs = (idx.data_ptr(), mask.data_ptr(), counts.data_ptr(),
            out.data_ptr(), est.data_ptr())
    times = kernel_times(
        lambda st: kernel.launch(*ptrs, n, b, w, tile, st),
        lambda st: kernel.launch(*ptrs, n, b, w, tile, st, empty=True),
        lambda: update_query(idx, mask, counts, tile),
        lambda: cms_update_query_fast(idx, mask, counts, block_b=tile))
    # every input read once, every output written once; per masked lane
    # five gathers, four mins and five adds
    nbytes = 4 * (idx.numel() + mask.numel() + 2 * counts.numel()
                  + est.numel())
    ops = 14 * int(mask.sum())
    return dict(shape=dict(n=n, b=b, w=w, tile=tile), **times,
                library_ms=None, **bound(nbytes, ops))


# --------------------------------------------------------------------------
# hot_gather kernel
# --------------------------------------------------------------------------
# the controller's three calls per period: (ids, hot ids, D)
HG_CALLS = ((128, 2048, 1), (2048, 2048, 1), (2048, 128, 1))
F32_TOL = 1e-6   # float32 rows, several matches a lane: the sum's order
# (ids, hot ids) of the cases aimed at the kernel's hash table
HG_TABLE_SIZES = ((1, 1), (300, 200), *[(b, c) for b, c, _ in HG_CALLS])


def hg_case(seed, b, c, d, dtype, distinct, dev, hot_kind=None):
    """(ids, hot, rows) on ``dev``: ids with misses and the -3 sentinel,
    hot ids repeated (unless ``distinct``) with -1 and -2 sentinels.
    ``hot_kind`` replaces the hot ids: "sentinel90" / "sentinel100" make
    90 % / all of them -2 (some ids ask for -2 too), "equal" makes them
    one id that half the lanes ask for, "multi" draws them from c // 8
    ids, several matches a lane."""
    rng = np.random.default_rng(seed)
    universe = 2 * c + 4
    if distinct:
        hot = rng.choice(universe, c, replace=False).astype(np.int32)
        hot[rng.integers(0, c)] = -2
    else:
        hot = rng.integers(0, max(2, c // 3), c).astype(np.int32)
        hot[rng.random(c) < 0.1] = -2
        hot[rng.random(c) < 0.05] = -1
    ids = rng.integers(0, universe, b).astype(np.int32)
    ids[rng.random(b) < 0.1] = -3
    if hot_kind in ("sentinel90", "sentinel100"):
        share = 0.9 if hot_kind == "sentinel90" else 1.0
        hot = rng.choice(universe, c, replace=False).astype(np.int32)
        hot[rng.permutation(c)[:int(round(share * c))]] = -2
        ids[rng.random(b) < 0.05] = -2
    elif hot_kind == "equal":
        hot[:] = 7
        ids[rng.random(b) < 0.5] = 7
    elif hot_kind == "multi":
        hot = rng.integers(0, max(1, c // 8), c).astype(np.int32)
        ids = rng.integers(-1, max(1, c // 8) + 1, b).astype(np.int32)
    rows = (rng.integers(-1000, 1000, (c, d)).astype(np.int32)
            if dtype == torch.int32
            else rng.normal(size=(c, d)).astype(np.float32))
    ids, hot, rows = (torch.from_numpy(a).to(dev) for a in (ids, hot, rows))
    return [ids, hot, rows.to(dtype)]


def hg_cases():
    """(b, c, d, dtype, distinct, hot_kind) of every on-card case: the
    fuzz grid and the controller's shapes, then the cases aimed at the hash
    table (sentinel-dense and all-equal hot vectors, several float32
    matches a lane at D = 64, more hot ids than one table holds)."""
    sizes = [(b, c, d) for b in (1, 128, 300) for c in (1, 128, 200)
             for d in (1, 3, 64)] + list(HG_CALLS)
    cases = [(b, c, d, dt, dist, None) for b, c, d in sizes
             for dt, dist in ((torch.int32, False), (torch.float32, True),
                              (torch.bfloat16, True),
                              (torch.bfloat16, False))]
    cases += [(b, c, d, dt, False, kind) for b, c in HG_TABLE_SIZES
              for kind in ("sentinel90", "sentinel100", "equal")
              for d in (1, 3) for dt in (torch.int32, torch.bfloat16)]
    cases += [(b, c, 64, dt, False, "multi")
              for b, c in ((1, 8), (128, 200), (300, 2048), (2048, 128))
              for dt in (torch.float32, torch.int32, torch.bfloat16)]
    # more hot ids than one of the kernel's tables holds (kernel.CHUNK)
    cases += [(b, c, d, dt, dist, kind)
              for b, c, d in ((300, 4097, 3), (2048, 9000, 1))
              for dt, dist, kind in (
                  (torch.float32, False, "multi"), (torch.int32, False, None),
                  (torch.int32, False, "equal"),
                  (torch.bfloat16, False, "sentinel90"),
                  (torch.float32, True, None))]
    return cases


def check_hot_gather(dev):
    """Every case of :func:`hg_cases` against the plain version: int32 and
    hit exactly, float32 within F32_TOL (exact where the hot ids are
    distinct), bf16 within BF16_TOL."""
    from repro_torch.kernels.hot_gather.ops import hot_gather
    from repro_torch.kernels.hot_gather.ref import hot_gather_ref

    cases = hg_cases()
    max_err = {"exact": 0.0, "f32": 0.0, "bf16": 0.0}
    for i, (b, c, d, dt, dist, kind) in enumerate(cases):
        args = hg_case(i, b, c, d, dt, dist, dev, kind)
        got = hot_gather(*args)
        want = hot_gather_ref(*args)
        torch.cuda.synchronize()
        for name, g, w in zip(("out", "hit"), got, want):
            if g.dtype == torch.bfloat16:
                key, tol = "bf16", BF16_TOL
            elif g.dtype == torch.float32 and not dist:
                key, tol = "f32", F32_TOL
            else:
                key, tol = "exact", 0.0
            err = max_abs_err(g, w)
            max_err[key] = max(max_err[key], err)
            ok = (torch.equal(g, w) if key == "exact" else torch.allclose(
                g.float(), w.float(), rtol=tol, atol=tol))
            if not ok:
                raise AssertionError(f"hot_gather kernel != plain version at "
                                     f"{name} (b={b} c={c} d={d} {dt} "
                                     f"{kind}, max abs err {err})")
    return len(cases), max_err


def hg_kernel_times(ids, hot, rows):
    """:func:`kernel_times` of one hot_gather input set."""
    from repro_torch.kernels.hot_gather import kernel
    from repro_torch.kernels.hot_gather.ops import hot_gather
    from repro_torch.kernels.hot_gather.ref import hot_gather_ref

    (b,), (c, d) = ids.shape, rows.shape
    out, hit = hot_gather(ids, hot, rows)
    ptrs = (ids.data_ptr(), hot.data_ptr(), rows.data_ptr(), out.data_ptr(),
            hit.data_ptr())
    return kernel_times(
        lambda st: kernel.launch(*ptrs, b, c, d, rows.dtype, st),
        lambda st: kernel.launch(*ptrs, b, c, d, rows.dtype, st, empty=True),
        lambda: hot_gather(ids, hot, rows),
        lambda: hot_gather_ref(ids, hot, rows))


def hg_bound(ids, hot, rows):
    """The least time of one call: inputs once, outputs once; the work of
    a table of the hot ids: an insert per hot id, a probe per (id,
    column) and an add per match and column."""
    (b,), (c, d) = ids.shape, rows.shape
    matches = int((ids[:, None] == hot[None, :]).sum())
    nbytes = 4 * (b + c + b) + rows.element_size() * (c * d + b * d)
    return bound(nbytes, c + b * d + matches * d)


def time_hot_gather(dev, yardsticks=True):
    """Times per launch at the controller's three call shapes, on int32
    rows and distinct hot ids, as the controller's inputs are (each lane
    matches at most once); the kernels line takes the largest.  With
    ``yardsticks``, the kernel's device time on repeated hot ids as well
    (several matches a lane, walked in ascending c), and for float32 and
    bf16 rows (distinct hot ids) the kernel's device time and the
    wrapper's ms beside the library's two calls ``(ids[:, None] ==
    hot[None, :]).to(rows.dtype) @ rows``, read both ways: events around
    direct calls (``_ms``, which include the host's issue cost) and the
    device alone (``_device_us``, the two calls captured in a CUDA
    graph)."""
    calls = []
    for b, c, d in HG_CALLS:
        ids, hot, rows = hg_case(b + c, b, c, d, torch.int32, True, dev)
        rec = dict(shape=dict(b=b, c=c, d=d),
                   **hg_kernel_times(ids, hot, rows))
        if yardsticks:
            rec["kernel_int32_repeated_device_us"] = hg_kernel_times(
                *hg_case(b + c, b, c, d, torch.int32, False, dev))[
                    "device_us"]
            for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                f_ids, f_hot, f_rows = hg_case(b + c, b, c, d, dt, True, dev)
                t = hg_kernel_times(f_ids, f_hot, f_rows)

                def two_calls(_stream=None):
                    return (f_ids[:, None] == f_hot[None, :]).to(
                        f_rows.dtype) @ f_rows
                rec[f"kernel_{tag}_device_us"] = t["device_us"]
                rec[f"wrapper_{tag}_ms"] = t["wrapper_ms"]
                rec[f"library_{tag}_two_calls_ms"] = timed(two_calls)
                rec[f"library_{tag}_two_calls_device_us"] = device_timed(
                    two_calls)[0]
            rec.update(hg_bound(ids, hot, rows))
        calls.append(rec)
    return calls


# --------------------------------------------------------------------------
# orbit_match kernel
# --------------------------------------------------------------------------
# lanes and entries of the fuzz cases; None is one subround's ingress of
# the paper's rack, read from its live carry
OM_LANES = (1, 31, None, 4096)
OM_ENTRIES = (1, 16, 128, 130, 1024)
OM_FLAGS = np.array([-1, 0, 1, 2], np.int32)


def om_case(seed, b, c, dup, mask, dev):
    """(hkey, table, occupied, valid, pop_mask) on ``dev``: int32 hash
    words, flags from {-1, 0, 1, 2} (true only where > 0), lanes that
    mostly hit; ``dup`` True copies a quarter of the entries onto others
    (some copies unoccupied), "all" fills the table with copies of four
    keys; ``mask`` is "none", "sparse" or "zero"."""
    from repro_torch.core.hashing import hash128_u32_np
    rng = np.random.default_rng(seed)
    universe = 2 * c + 4
    keys = rng.choice(universe, c, replace=False).astype(np.int32)
    if dup == "all":
        keys = keys[rng.integers(0, min(4, c), c)]
    elif dup:
        n = max(1, c // 4)
        keys[rng.integers(0, c, n)] = keys[rng.integers(0, c, n)]
    occ, valid = rng.choice(OM_FLAGS, c), rng.choice(OM_FLAGS, c)
    q = np.where(rng.random(b) < 0.7, keys[rng.integers(0, c, b)],
                 rng.integers(0, universe, b)).astype(np.int32)
    pop_mask = {"none": None, "zero": np.zeros(b, np.int32),
                "sparse": np.where(rng.random(b) < 0.1,
                                   rng.choice(OM_FLAGS, b), 0)}[mask]
    hk = lambda k: hash128_u32_np(k).view(np.int32)
    return [None if a is None else torch.from_numpy(
                np.ascontiguousarray(a, np.int32)).to(dev)
            for a in (hk(q), hk(keys), occ, valid, pop_mask)]


def live_match_inputs(sim):
    """The rack's table ``(hkeys, occupied, valid)`` and one window's
    ingress, ``[(hkey, pop_mask)]`` per subround (the mask is the valid
    R-REQ lanes, which the switch counts), drawn from the live carry; the
    draw source is rewound, so the run that follows sees the same draws."""
    from repro_torch.core.types import OP_R_REQ
    from repro_torch.kvstore.simulator import generate_ingress

    state = sim.carry.draws.get_state()
    _, _, sub = generate_ingress(sim.cfg, sim.client_cfg, sim.wl.arrays,
                                 sim.carry)
    sim.carry.draws.set_state(state)
    sw = sim.carry.policy
    table = (sw.lookup.hkeys.clone(), sw.lookup.occupied.to(torch.int32),
             sw.state.valid.to(torch.int32))
    lanes = [(sub.hkey[r].contiguous(),
              (sub.valid[r] & (sub.op[r] == OP_R_REQ)).to(torch.int32))
             for r in range(sub.op.shape[0])]
    return table, lanes


def check_orbit_match(dev, live):
    from repro_torch.kernels.orbit_match.kernel import CHUNK, CLUSTER_LANES
    from repro_torch.kernels.orbit_match.ops import orbit_match
    from repro_torch.kernels.orbit_match.ref import orbit_match_ref

    table, lanes = live
    b_live = lanes[0][0].shape[0]
    cases = [(b_live if b is None else b, c, dup, mask)
             for b in OM_LANES for c in OM_ENTRIES for dup in (False, True)
             for mask in ("none", "sparse", "zero")]
    # past one cluster's lanes (the threads loop), at one chunk of entries
    # and past it (three passes over the table), and tables of nothing but
    # duplicates
    cases += [(b, c, dup, mask)
              for b, c in ((CLUSTER_LANES + 1808, 128), (b_live, CHUNK),
                           (b_live, 2 * CHUNK + 808),
                           (CLUSTER_LANES + 1808, 2 * CHUNK + 808),
                           (1025, 16), (2048, 1024))
              for dup in (False, True, "all") for mask in ("none", "sparse")]
    cases += [(b, c, "all", mask) for b in (b_live, 31) for c in (1, 128, 130)
              for mask in ("none", "sparse", "zero")]
    inputs = [om_case(i, b, c, dup, mask, dev)
              for i, (b, c, dup, mask) in enumerate(cases)]
    cases += [("live", r) for r in range(len(lanes))]
    inputs += [[hk, *table, m] for hk, m in lanes]
    max_err = 0.0
    for case, args in zip(cases, inputs):
        got = orbit_match(*args)
        want = orbit_match_ref(*args)
        torch.cuda.synchronize()
        for name, g, w in zip(("cidx", "hit", "valid_hit", "pop"), got, want):
            max_err = max(max_err, max_abs_err(g, w))
            if not torch.equal(g, w):
                raise AssertionError(f"orbit_match kernel != plain version "
                                     f"at {name} ({case})")
    return len(cases), max_err


def om_work(hkey, thk, occ, mask):
    """(bytes, operations) of one call: inputs once, outputs once; the
    work of entries grouped into 256 buckets by their first word's top
    byte: two per entry (its count and its place), a first-word compare
    per (lane, entry of the lane's bucket), an occupancy test and three
    word compares per (lane, entry) whose first words agree, an add per
    counted match."""
    b, c = hkey.shape[0], thk.shape[0]
    nbytes = 4 * (4 * b + 4 * c + 2 * c + b + 3 * b + c)
    top = lambda w: (w >> 24) & 0xFF
    per_bucket = torch.bincount(top(thk[:, 0]).long(), minlength=256)
    bucket_compares = int(per_bucket[top(hkey[:, 0]).long()].sum())
    first = hkey[:, None, 0] == thk[None, :, 0]
    match = ((hkey[:, None, :] == thk[None, :, :]).all(dim=-1)
             & (occ > 0)[None, :] & (mask > 0)[:, None])
    return nbytes, (2 * c + bucket_compares + 4 * int(first.sum())
                    + int(match.sum()))


def time_orbit_match(dev):
    """:func:`kernel_times` of the kernel on one synthetic input set of
    the paper rack's shape (352 lanes, 128 entries, sparse mask)."""
    from repro_torch.kernels.orbit_match import kernel
    from repro_torch.kernels.orbit_match.ops import orbit_match
    from repro_torch.kernels.orbit_match.ref import orbit_match_ref

    args = om_case(7, 352, 128, False, "sparse", dev)
    outs = orbit_match(*args)
    ptrs = [a.data_ptr() for a in (*args, *outs)]
    return dict(shape=dict(b=352, c=128), **kernel_times(
        lambda st: kernel.launch(*ptrs, 352, 128, st),
        lambda st: kernel.launch(*ptrs, 352, 128, st, empty=True),
        lambda: orbit_match(*args),
        lambda: orbit_match_ref(*args)))


def run_orbit_match(dev, live):
    """The orbit_match phase (module docstring, phase 6).  Returns the
    kernels-line numbers."""
    from repro_torch import kernels as kn
    from repro_torch.kernels.orbit_match import kernel
    from repro_torch.kernels.orbit_match.ops import orbit_match
    from repro_torch.kernels.orbit_match.ref import orbit_match_ref

    n_cases, err = check_orbit_match(dev, live)
    (thk, occ, val), lanes = live
    hkey, mask = lanes[0]
    b, c = hkey.shape[0], thk.shape[0]
    outs = orbit_match(hkey, thk, occ, val, mask)
    ptrs = [a.data_ptr() for a in (hkey, thk, occ, val, mask, *outs)]
    times = kernel_times(
        lambda st: kernel.launch(*ptrs, b, c, st),
        lambda st: kernel.launch(*ptrs, b, c, st, empty=True),
        lambda: orbit_match(hkey, thk, occ, val, mask),
        lambda: orbit_match_ref(hkey, thk, occ, val, mask))
    nbytes, n_ops = om_work(hkey, thk, occ, mask)

    # its own entry point, one call per subround of the window, counted
    with counting_plain_versions() as plain_calls:
        kn.reset_launch_counts()
        results = [kn.orbit_match(hk, thk, occ, val, m) for hk, m in lanes]
        torch.cuda.synchronize()
        launches = dict(kn.LAUNCHES)
        calls = dict(plain_calls)
    want = dict.fromkeys(launches, 0) | {"orbit_match": len(lanes)}
    if launches != want or any(calls.values()):
        raise AssertionError(f"orbit_match entry point launched {launches}, "
                             f"plain versions {calls}; want {want}")
    for (hk, m), got in zip(lanes, results):
        for g, w in zip(got, orbit_match_ref(hk, thk, occ, val, m)):
            if not torch.equal(g, w):
                raise AssertionError("orbit_match entry point != plain")
    hits = sum(int(r[1].sum()) for r in results)
    if not hits:
        raise AssertionError("no lane of the live ingress hit the table")
    rec = dict(**times, library_ms=None, **bound(nbytes, n_ops))
    phase("orbit_match_vs_plain", cases=n_cases, equal=True,
          max_abs_err=err, shape=dict(b=b, c=c), **rec,
          entry_point=dict(calls=len(lanes), launches=launches,
                           lanes=sum(hk.shape[0] for hk, _ in lanes),
                           hits=hits,
                           valid_hits=sum(int(r[2].sum()) for r in results),
                           pop=sum(int(r[3].sum()) for r in results)))
    return dict(rec, launches=launches["orbit_match"], max_abs_err=err)


# --------------------------------------------------------------------------
# main path
# --------------------------------------------------------------------------
def clone_tree(x, device=None):
    """A copy of a tree of tensors (on ``device`` if given); a NamedTuple
    keeps its class, a plain tuple (NoCache's policy ``()``) stays one."""
    if isinstance(x, torch.Tensor):
        return x.clone() if device is None else x.to(device, copy=True)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone_tree(v, device) for v in x))
    if isinstance(x, tuple):
        return tuple(clone_tree(v, device) for v in x)
    return x


@contextlib.contextmanager
def counting_plain_versions():
    """Count every call of the kernels' plain versions (the dispatchers
    look them up on their modules at each call)."""
    from repro_torch.kernels.cms import ref as cms_ref
    from repro_torch.kernels.hot_gather import ref as hg_ref
    from repro_torch.kernels.orbit_match import ref as om_ref
    from repro_torch.kernels.subround import ref as sr_ref

    targets = {"subround": (sr_ref, "subround_ref"),
               "cms": (cms_ref, "cms_update_query_fast"),
               "cms_one_hot": (cms_ref, "cms_update_query_ref"),
               "hot_gather": (hg_ref, "hot_gather_ref"),
               "orbit_match": (om_ref, "orbit_match_ref")}
    calls = {k: 0 for k in targets}
    real = {k: getattr(m, f) for k, (m, f) in targets.items()}

    def counted(key):
        def fn(*a, **k):
            calls[key] += 1
            return real[key](*a, **k)
        return fn

    for key, (mod, fn_name) in targets.items():
        setattr(mod, fn_name, counted(key))
    try:
        yield calls
    finally:
        for key, (mod, fn_name) in targets.items():
            setattr(mod, fn_name, real[key])


def run_main_path(dev):
    from repro_torch import kernels as kn
    from repro_torch.configs.orbitcache_paper import RACK, WORKLOAD
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
    live = live_match_inputs(sim)

    seconds = WINDOWS * RACK.window_us * 1e-6
    with counting_plain_versions() as plain_calls:
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
        if any(plain_calls.values()):
            raise AssertionError(f"plain versions ran on the kernel path: "
                                 f"{plain_calls}")
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

    def rewind():
        sim.carry = clone_tree(start)
        sim.carry.draws.set_state(gen_state)

    def drive():
        return [sim.run(EAGER_WINDOWS * RACK.window_us * 1e-6,
                        chunk_windows=WINDOWS // 4).traces]

    # graphed against eager chunks on the kernel path, over the first
    # EAGER_WINDOWS windows (the eager side is the slow one)
    wall_g, wall_e, n_leaves, n_out, graphed = graphed_and_eager(
        "orbitcache", sim, drive, rewind)
    # the same draws from the same carry through the plain version
    with counting_plain_versions() as plain_calls:
        wall_ref, n_ref, n_out_ref = plain_replay("orbitcache", sim, drive,
                                                  rewind, graphed)
    if plain_calls["subround"] != RACK.subrounds * EAGER_WINDOWS:
        raise AssertionError(f"plain replay ran {plain_calls} calls")
    phase("replay_plain", windows=EAGER_WINDOWS, seconds=round(wall_ref, 3),
          equal_leaves=n_ref, equal_metrics=n_out_ref)

    # what the profiler sees of a short run, eager then graphed
    prof_windows = PROFILE_WINDOWS
    rewind()
    sim.chunk.graphs = False
    kn.reset_launch_counts()
    dev_events, prof_wall = device_profile(
        lambda: sim.run_windows(prof_windows))
    sim.chunk.graphs = True
    sub = sum(e.count for e in dev_events if "subround_kernel" in e.key)
    if sub != RACK.subrounds * prof_windows:
        raise AssertionError(f"profiler saw {sub} subround kernels in "
                             f"{prof_windows} windows")
    busy_eager = busy_per_window(None, prof_windows, dev_events, prof_wall)
    sub_us = device_us(dev_events, "subround_kernel")
    phase("profile", windows=prof_windows, subround_kernels=sub,
          launch_count=kn.LAUNCHES["subround"],
          subround_device_us_per_window=sub_us / prof_windows,
          subround_device_us_per_launch=sub_us / max(sub, 1),
          device_kernels=sum(e.count for e in dev_events),
          device_busy_ms_per_window=busy_eager["device_ms_per_window"])
    rewind()
    busy_graphed = busy_per_window(lambda: sim.run_windows(prof_windows),
                                   prof_windows)
    phase("graphed_vs_eager", cell="orbitcache", windows=EAGER_WINDOWS,
          equal_leaves=n_leaves, equal_metrics=n_out,
          graphed=dict(rates(EAGER_WINDOWS, wall_g, busy_graphed),
                       **graph_stats(sim)),
          eager=rates(EAGER_WINDOWS, wall_e, busy_eager))
    no_sync("orbitcache", sim)
    return launches, live, wl


def control_plane_rack(dev):
    """The paper's rack with the servers' popularity tracking on and its
    hottest keys preloaded: ``(simulator, workload, windows a period)``."""
    from repro_torch.configs.orbitcache_paper import RACK, WORKLOAD
    from repro_torch.kvstore.simulator import RackSimulator
    from repro_torch.kvstore.workload import Workload

    rack = dataclasses.replace(RACK, track_popularity=True)
    wl = Workload(WORKLOAD, device=dev)
    sim = RackSimulator(rack, wl)
    sim.preload(wl.hottest_keys(rack.cache_entries))
    return sim, wl, int(round(CP_PERIOD_S / (rack.window_us * 1e-6)))


def run_control_plane(dev):
    """The periodic control plane at the paper's scale (module docstring,
    phase 5).  Returns the launches of each kernel in the run."""
    from repro_torch import kernels as kn

    sim, wl, period_w = control_plane_rack(dev)
    rack = sim.cfg
    start = clone_tree(sim.carry)
    gen_state = sim.carry.draws.get_state()
    act0, perm0 = sim.controller.active_size, wl._perm_np.copy()

    def drive(phase_s=CP_PHASE_S):
        """The three phases; returns their results and every period's
        update."""
        results, updates = [], []
        for p in range(CP_PHASES):
            if p:
                wl.hot_in_swap(CP_SWAP)
            results.append(sim.run(
                phase_s, controller_period_s=CP_PERIOD_S,
                on_period=lambda s, w: updates.append(s._last_update)))
        return results, updates

    def rewind():
        sim.carry = clone_tree(start)
        sim.carry.draws.set_state(gen_state)
        sim.controller.active_size = act0
        wl._perm_np[:] = perm0
        wl.perm = torch.from_numpy(perm0.copy()).to(dev)

    n_win = CP_PHASES * int(round(CP_PHASE_S / (rack.window_us * 1e-6)))
    n_periods = n_win // period_w
    want = {"subround": rack.subrounds * n_win, "cms": n_win,
            "hot_gather": 3 * n_periods}
    with counting_plain_versions() as plain_calls:
        kn.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results, updates = drive()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kn.LAUNCHES)
        if (launches != dict.fromkeys(launches, 0) | want
                or len(updates) != n_periods):
            raise AssertionError(f"control plane launched {launches} in "
                                 f"{len(updates)} periods; want {want}")
        if any(plain_calls.values()):
            raise AssertionError(f"plain versions ran on the kernel path: "
                                 f"{plain_calls}")
        act_cuda = sim.controller.active_size
        win_s = rack.window_us * 1e-6
        ppp = n_periods // CP_PHASES      # periods per phase
        per_phase = []
        for res in results:
            rx = (res.traces["rx_switch"].astype(np.int64)
                  + res.traces["rx_server"].astype(np.int64))
            q = len(rx) // 4
            per_phase.append(dict(
                early_rps=float(rx[:q].sum() / (q * win_s)),
                late_rps=float(rx[-q:].sum() / (q * win_s)),
                overflow_ratio=res.overflow_ratio(),
                inserted=int(sum(int(u.n_insert.sum()) for u in
                                 updates[len(per_phase) * ppp:
                                         (len(per_phase) + 1) * ppp]))))
        phase("control_plane", windows=n_win, periods=n_periods,
              seconds=round(wall, 3), windows_per_s=round(n_win / wall, 1),
              phases=per_phase, active_size=act_cuda,
              recovery=min(per_phase[1]["late_rps"], per_phase[2]["late_rps"])
              / max(per_phase[0]["late_rps"], 1.0),
              launches=launches,
              peak_device_mib=round(torch.cuda.max_memory_allocated(dev)
                                    / 2**20, 1))
        if not all(p["late_rps"] > 0 for p in per_phase):
            raise AssertionError("the rack served nothing in a phase")
        if not any(p["inserted"] for p in per_phase[1:]):
            raise AssertionError("the controller inserted nothing after "
                                 "the churn")


    # graphed against eager chunks on the kernel path: the three phases
    # and both swaps, each phase cut to CP_EAGER_S
    def outputs():
        results, updates = drive(CP_EAGER_S)
        return ([r.traces for r in results] + [u._asdict() for u in updates]
                + [dict(active_size=np.array(sim.controller.active_size))])

    wall_g, wall_e, n_leaves, n_out, graphed = graphed_and_eager(
        "control_plane", sim, outputs, rewind)
    n_cmp = CP_PHASES * int(round(CP_EAGER_S / (rack.window_us * 1e-6)))
    # the same draws, carry and workload through the plain versions
    with counting_plain_versions() as plain_calls:
        wall_ref, n_ref, n_out_ref = plain_replay(
            "control_plane", sim, outputs, rewind, graphed)
    want_plain = (rack.subrounds * n_cmp, n_cmp, 3 * (n_cmp // period_w))
    if (plain_calls["subround"], plain_calls["cms"],
            plain_calls["hot_gather"]) != want_plain:
        raise AssertionError(f"plain replay ran {plain_calls} calls")
    phase("control_plane_replay_plain", windows=n_cmp,
          periods=n_cmp // period_w, seconds=round(wall_ref, 3),
          equal_leaves=n_ref, equal_outputs=n_out_ref)

    # what the profiler sees of one period of PROFILE_WINDOWS windows,
    # eager then graphed
    pw = PROFILE_WINDOWS
    rewind()
    sim.chunk.graphs = False
    kn.reset_launch_counts()
    dev_events, prof_wall = device_profile(lambda: sim.run_periods(1, pw))
    sim.chunk.graphs = True
    by_kernel = {k: sum(e.count for e in dev_events if f"{k}_kernel"
                        in e.key) for k in want}
    us_by_kernel = {k: device_us(dev_events, f"{k}_kernel") for k in want}
    if by_kernel != {"subround": rack.subrounds * pw, "cms": pw,
                     "hot_gather": 3}:
        raise AssertionError(f"profiler saw {by_kernel} in one period")
    busy_eager = busy_per_window(None, pw, dev_events, prof_wall)
    phase("control_plane_profile", windows=pw,
          kernels_seen=by_kernel, kernel_device_us=us_by_kernel,
          kernel_device_us_per_window={
              k: v / pw for k, v in us_by_kernel.items()},
          kernel_device_us_per_launch={
              k: v / by_kernel[k] for k, v in us_by_kernel.items()},
          device_kernels=sum(e.count for e in dev_events),
          device_busy_ms_per_window=busy_eager["device_ms_per_window"])
    rewind()
    busy_graphed = busy_per_window(lambda: sim.run_periods(1, pw), pw)
    phase("graphed_vs_eager", cell="control_plane", windows=n_cmp,
          periods=n_cmp // period_w, equal_leaves=n_leaves,
          equal_outputs=n_out,
          graphed=dict(rates(n_cmp, wall_g, busy_graphed),
                       **graph_stats(sim)),
          eager=rates(n_cmp, wall_e, busy_eager))
    no_sync("control_plane", sim, period_w)
    rewind()
    run_hot_gather_live(sim, period_w)
    return launches


def merge_inputs(sim, period_w):
    """The three ``(ids, hot, rows)`` input sets of one period's
    ``_merge_scores``, recorded through its dispatcher as ``sim`` runs the
    period."""
    from repro_torch import kernels as kn

    recorded, real = [], kn.hot_gather

    def record(*args):
        recorded.append([a.clone() for a in args])
        return real(*args)

    kn.hot_gather = record
    sim.chunk.graphs = False        # a graph would replay past the recorder
    try:
        sim.run_periods(1, period_w)
    finally:
        kn.hot_gather = real
        sim.chunk.graphs = True
    if len(recorded) != 3:
        raise AssertionError(f"{len(recorded)} hot_gather calls in a period")
    return recorded


def run_hot_gather_live(sim, period_w):
    """The three input sets of one period's ``_merge_scores`` (recorded
    from a period of the live carry), each held against the plain version
    and timed."""
    from repro_torch.kernels.hot_gather.ops import hot_gather
    from repro_torch.kernels.hot_gather.ref import hot_gather_ref

    calls = []
    for ids, hot, rows in merge_inputs(sim, period_w):
        got, want = hot_gather(ids, hot, rows), hot_gather_ref(ids, hot, rows)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"hot_gather kernel != plain version on the "
                                 f"live inputs {tuple(ids.shape)} x "
                                 f"{tuple(hot.shape)}")
        calls.append(dict(
            shape=dict(b=ids.shape[0], c=hot.shape[0], d=rows.shape[1]),
            hot_sentinels=int((hot == -2).sum()),
            id_sentinels=int((ids == -3).sum()), hits=int(got[1].sum()),
            **hg_kernel_times(ids, hot, rows), **hg_bound(ids, hot, rows)))
    phase("hot_gather_live", equal=True, calls=calls)


def run_schemes(dev):
    """NoCache and NetCache on the paper's rack (module docstring, phase
    7)."""
    from repro_torch import kernels as kn
    from repro_torch.configs.orbitcache_paper import RACK, WORKLOAD
    from repro_torch.interop import to_numpy
    from repro_torch.kvstore.client import ReplayDraws
    from repro_torch.kvstore.simulator import RackSimulator
    from repro_torch.kvstore.workload import Workload

    wl = Workload(WORKLOAD, device=dev)
    wl_cpu = Workload(WORKLOAD, device="cpu")
    for i, scheme in enumerate(("nocache", "netcache")):
        rack = dataclasses.replace(RACK, scheme=scheme)
        sim = RackSimulator(rack, wl)
        if scheme == "netcache":
            sim.preload(wl.hottest_keys(rack.netcache_entries))
        n_win = int(round(SCHEME_S / (rack.window_us * 1e-6)))
        start = clone_tree(sim.carry)
        gen_state = sim.carry.draws.get_state()
        with counting_plain_versions() as plain_calls:
            kn.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sim.run(SCHEME_S, chunk_windows=n_win)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, calls = dict(kn.LAUNCHES), dict(plain_calls)
        if any(launches.values()) or any(calls.values()):
            raise AssertionError(f"{scheme} launched {launches} and ran "
                                 f"plain versions {calls}")
        rx_sw = res.traces["rx_switch"].astype(np.int64).sum()
        rx_srv = res.traces["rx_server"].astype(np.int64).sum()
        hits = int(res.traces["hits"].astype(np.int64).sum())
        installed = getattr(sim, "_installed", None)
        if len(res.traces["tx"]) != n_win or not res.throughput_rps() > 0:
            raise AssertionError(f"{scheme}: {len(res.traces['tx'])} "
                                 f"windows, nothing served")
        if scheme == "nocache" and rx_sw != 0:
            raise AssertionError("nocache: the switch answered requests")
        if scheme == "netcache" and not (hits > 0 and installed > 0):
            raise AssertionError(f"netcache: {installed} installed, {hits} "
                                 f"hits")
        phase("scheme", scheme=scheme, windows=n_win, seconds=round(wall, 3),
              windows_per_s=round(n_win / wall, 1),
              throughput_rps=res.throughput_rps(),
              offered_rps=res.offered_rps(),
              switch_share=float(rx_sw / max(rx_sw + rx_srv, 1)),
              balancing_efficiency=res.balancing_efficiency(),
              p50_us=res.latency_percentile(0.5),
              p99_us=res.latency_percentile(0.99), hits=hits,
              installed=installed, launches=launches, plain_calls=calls)
        def rewind():
            sim.carry = clone_tree(start)
            sim.carry.draws.set_state(gen_state)

        n_cmp = int(round(SCHEME_EAGER_S / (rack.window_us * 1e-6)))
        wall_g, wall_e, n_leaves, n_out, _ = graphed_and_eager(
            scheme, sim,
            lambda: [sim.run(SCHEME_EAGER_S, chunk_windows=n_cmp).traces],
            rewind)
        prof_windows = PROFILE_WINDOWS
        busy = {}
        for graphs in (False, True):
            rewind()
            sim.chunk.graphs = graphs
            busy[graphs] = busy_per_window(
                lambda: sim.run_windows(prof_windows), prof_windows)
        phase("graphed_vs_eager", cell=scheme, windows=n_cmp,
              equal_leaves=n_leaves, equal_metrics=n_out,
              graphed=dict(rates(n_cmp, wall_g, busy[True]),
                           **graph_stats(sim)),
              eager=rates(n_cmp, wall_e, busy[False]))
        no_sync(scheme, sim)

        # the card against the CPU: one carry, one set of numpy-made draws,
        # writes on so that invalidations and installs run (a clone: the
        # card's chunk overwrites the carry it leaves in ``sim.carry``)
        start = clone_tree(sim.carry)._replace(write_ratio=torch.tensor(
            0.1, dtype=torch.float32, device=dev))
        rng = np.random.default_rng(100 + i)
        w_n, b = SCHEME_CHECK_WINDOWS, rack.client_batch
        draws = (rng.poisson(float(start.offered), w_n),
                 rng.random((w_n, b), dtype=np.float32),
                 rng.random((w_n, b), dtype=np.float32))
        sim.carry = clone_tree(start)._replace(
            draws=ReplayDraws(*draws, dev))
        m_dev = sim.run_windows(w_n)
        cpu = RackSimulator(rack, wl_cpu, device="cpu",
                            draws=ReplayDraws(*draws, "cpu"))
        cpu.carry = clone_tree(start, "cpu")._replace(draws=cpu.carry.draws)
        t0 = time.perf_counter()
        m_cpu = cpu.run_windows(w_n)
        cpu_s = time.perf_counter() - t0
        for k, v in m_dev.items():
            if v.dtype != m_cpu[k].dtype or not np.array_equal(v, m_cpu[k]):
                raise AssertionError(f"{scheme}: card and CPU differ in "
                                     f"metric {k}")
        n_leaves = compare_trees(to_numpy(sim.carry), to_numpy(cpu.carry),
                                 f"{scheme} carry")
        phase("scheme_card_vs_cpu", scheme=scheme, windows=w_n,
              write_ratio=0.1, equal_leaves=n_leaves,
              equal_metrics=len(m_dev), cpu_seconds=round(cpu_s, 3),
              hits=int(m_dev["hits"].astype(np.int64).sum()),
              forwarded=int(m_dev["fwd"].astype(np.int64).sum()))


# --------------------------------------------------------------------------
# the fleet: batched kernels, then the three fleet cells
# --------------------------------------------------------------------------
FLEET_P = (1, 4, 12)          # points per batched launch, timed
FLEET_FUZZ = 8                # fuzz cases per kernel, P and sharing
# benchmarks/common.py DEFAULT_LOADS: the staircase of Fig. 11's curve
STAIRCASE_LOADS = tuple(0.5e6 * (i + 1) for i in range(12))
STAIRCASE_S = 0.03            # knee_throughput_parallel's seconds
FLEET_CP_POINTS = 4           # fig18_dynamic_batched's seeds
SKEW_ALPHAS = (0.9, 0.95, 0.99)   # Fig. 9's quick skew sweep
SKEW_S = 0.03
FLEET_CHECK_WINDOWS = 16      # plain and eager replays of the staircase


def stack_points(per, shared):
    """P argument lists -> one list, each argument stacked on a leading
    point axis, or point 0's where its index is in ``shared``; and the
    batched flags."""
    args = [per[0][k] if k in shared else torch.stack([x[k] for x in per])
            for k in range(len(per[0]))]
    return args, [k not in shared for k in range(len(per[0]))]


def point_args(args, batched, i):
    return [a[i] if bt else a for a, bt in zip(args, batched)]


def nbytes_of(*tensors):
    """Bytes of the tensors: each input read once (a shared one once for
    all points) and each output written once."""
    return sum(t.numel() * t.element_size() for t in tensors)


def batched_times(single_us, launch_for):
    """``device_us`` of one batched launch at each P of ``FLEET_P`` beside
    P x the single launch's, with the bound of the batch's bytes;
    ``launch_for(p)`` gives ``(bytes, launch(stream))``."""
    rows = []
    for p in FLEET_P:
        nbytes, launch = launch_for(p)
        us, method = device_timed(launch)
        rows.append(dict(p=p, device_us=us, device_timing=method,
                         p_x_single_us=p * single_us, **bound(nbytes, 0)))
    return rows


SR_SHARING = {"none": (), "tables": tuple(range(12, 30)),
              "lanes": tuple(range(12)), "budget": (30,)}


def check_subround_batched(dev):
    """The batched subround (one launch of P blocks) against the plain
    version once per point, over fuzz cases at two shapes with each
    sharing; then its device time at the paper's shape for P = 1, 4, 12
    (no input shared, as the fleet's) beside P x the serial launch's."""
    from repro_torch.kernels.subround import kernel
    from repro_torch.kernels.subround.ops import (
        SubroundOuts, subround, subround_batched,
    )
    from repro_torch.kernels.subround.ref import subround_ref

    def tensors(seed, shape, **kw):
        b, c, s, f, _ = shape
        return [torch.from_numpy(np.array(a)).to(dev)
                for a in subround_case(seed, b, c, s, f, **kw)]

    n_cases, max_err = 0, 0.0
    for shape in (FUZZ_SHAPES[1], PAPER):
        b, c, s, f, j = shape
        for p in FLEET_P:
            for k, shared in enumerate(SR_SHARING.values()):
                for r in range(FLEET_FUZZ // 4):
                    seed = 9000 + 100 * p + 10 * k + r
                    per = [tensors(seed + i, shape) for i in range(p)]
                    args, batched = stack_points(per, shared)
                    got = subround_batched(args, batched, p, s, f, j)
                    for i in range(p):
                        want = subround_ref(*point_args(args, batched, i),
                                            queue_size=s, max_frags=f,
                                            max_serves=j)
                        for name, g, w in zip(SubroundOuts._fields, got,
                                              want):
                            max_err = max(max_err, max_abs_err(g[i], w))
                            if not torch.equal(g[i], w):
                                raise AssertionError(
                                    f"batched subround != plain at {name} "
                                    f"(shape {shape}, P={p}, shared {k}, "
                                    f"point {i})")
                    n_cases += 1
    b, c, s, f, j = PAPER
    one = tensors(7, PAPER, budget=1000)
    outs = subround(*one, s, f, j)
    ptrs = ([a.data_ptr() for a in one[:-1]] + [one[-1].reshape(1).data_ptr()]
            + [o.data_ptr() for o in outs])
    single_us, _ = device_timed(
        lambda st: kernel.launch(ptrs, b, c, s, f, j, st))

    def launch_for(p):
        per = [tensors(7 + i, PAPER, budget=1000) for i in range(p)]
        args, batched = stack_points(per, ())
        got = subround_batched(args, batched, p, s, f, j)
        bptrs = ([a.data_ptr() for a in args] + [o.data_ptr() for o in got])
        strides = ([a[0].numel() for a in args]
                   + [o[0].numel() for o in got])

        def launch(st, held=(args, got)):    # the tensors outlive the call
            if p == 1 and not launch_for.template:   # the wrapper's choice
                kernel.launch(bptrs, b, c, s, f, j, st)
            else:
                kernel.launch_batched(bptrs, strides, p, b, c, s, f, j, st)
        return nbytes_of(*args, *got), launch
    launch_for.template = False
    times = batched_times(single_us, launch_for)
    # the batched kernel itself at P = 1, which the wrapper does not launch
    launch_for.template = True
    template_p1_us, _ = device_timed(launch_for(1)[1])
    return n_cases, max_err, dict(single_device_us=single_us, shape=PAPER,
                                  batched=times,
                                  batched_kernel_p1_device_us=template_p1_us)


def check_cms_batched(dev):
    """The batched count-min (P x 32 sketches, row indices per point or
    shared) against the plain version once per point; then its device
    time at the rack's shape for P = 1, 4, 12 beside P x the single
    launch's."""
    from repro_torch.kernels.cms import kernel
    from repro_torch.kernels.cms.ops import (
        tile_for, update_query, update_query_batched,
    )
    from repro_torch.kernels.cms.ref import cms_update_query_fast

    n_cases, max_err = 0, 0.0
    for n, b, w, blk in ((4, 257, 64, 32), (*CMS_PAPER, 256)):
        tile = tile_for(b, blk)
        for p in FLEET_P:
            for shared in ((), (0,)):
                per = [cms_case(700 + 10 * p + i, n, b, w, 1 / 8, dev)
                       for i in range(p)]
                (idx, mask, counts), _ = stack_points(per, shared)
                got = update_query_batched(idx, mask, counts, tile)
                for i in range(p):
                    want = cms_update_query_fast(
                        idx if shared else idx[i], mask[i], counts[i],
                        block_b=tile)
                    for g, wt in zip(got, want):
                        max_err = max(max_err, max_abs_err(g[i], wt))
                        if not torch.equal(g[i], wt):
                            raise AssertionError(
                                f"batched cms != plain (n={n} b={b} P={p} "
                                f"shared idx {bool(shared)}, point {i})")
                n_cases += 1
    n, b, w = CMS_PAPER
    tile = tile_for(b)
    idx, mask, counts = cms_case(7, n, b, w, 1 / 32, dev)
    out, est = update_query(idx, mask, counts, tile)
    single_us, _ = device_timed(lambda st: kernel.launch(
        idx.data_ptr(), mask.data_ptr(), counts.data_ptr(), out.data_ptr(),
        est.data_ptr(), n, b, w, tile, st))

    def launch_for(p):
        per = [cms_case(7 + i, n, b, w, 1 / 32, dev) for i in range(p)]
        (pidx, pmask, pcounts), _ = stack_points(per, ())
        pout, pest = update_query_batched(pidx, pmask, pcounts, tile)
        return nbytes_of(pidx, pmask, pcounts, pout, pest), \
            lambda st: kernel.launch_batched(
                pidx.data_ptr(), b * 5, n, pmask.data_ptr(),
                pcounts.data_ptr(), pout.data_ptr(), pest.data_ptr(), p * n,
                b, w, tile, st)
    times = batched_times(single_us, launch_for)
    return n_cases, max_err, dict(single_device_us=single_us,
                                  shape=dict(n=n, b=b, w=w), batched=times)


HG_SHARING = {"none": (), "ids": (0,), "hot": (1,), "rows": (2,)}


def check_hot_gather_batched(dev):
    """The batched hot_gather (grid z = P) against the plain version once
    per point, at the controller's three call shapes with each sharing
    (the third call's zero rows are shared by every point); then its
    device time at each shape for P = 1, 4, 12 (the third with shared
    rows, as the fleet's) beside P x the single launch's."""
    from repro_torch.kernels.hot_gather import kernel
    from repro_torch.kernels.hot_gather.ops import (
        hot_gather, hot_gather_batched,
    )
    from repro_torch.kernels.hot_gather.ref import hot_gather_ref

    n_cases, max_err = 0, 0.0
    for b, c, d in HG_CALLS + ((300, 200, 3),):
        for p in FLEET_P:
            for k, shared in enumerate(HG_SHARING.values()):
                per = [hg_case(500 + 10 * p + k + i, b, c, d, torch.int32,
                               True, dev) for i in range(p)]
                args, batched = stack_points(per, shared)
                got = hot_gather_batched(*args, p)
                for i in range(p):
                    want = hot_gather_ref(*point_args(args, batched, i))
                    for g, w in zip(got, want):
                        max_err = max(max_err, max_abs_err(g[i], w))
                        if not torch.equal(g[i], w):
                            raise AssertionError(
                                f"batched hot_gather != plain (b={b} c={c} "
                                f"P={p} shared {k}, point {i})")
                n_cases += 1
    calls = []
    for call, (b, c, d) in enumerate(HG_CALLS):
        shared = (2,) if call == 2 else ()
        ids, hot, rows = hg_case(b + c, b, c, d, torch.int32, True, dev)
        out, hit = hot_gather(ids, hot, rows)
        single_us, _ = device_timed(lambda st: kernel.launch(
            ids.data_ptr(), hot.data_ptr(), rows.data_ptr(), out.data_ptr(),
            hit.data_ptr(), b, c, d, rows.dtype, st))

        def launch_for(p, b=b, c=c, d=d, shared=shared):
            per = [hg_case(b + c + i, b, c, d, torch.int32, True, dev)
                   for i in range(p)]
            args, batched = stack_points(per, shared)
            pout, phit = hot_gather_batched(*args, p)
            strides = [a[0].numel() if bt else 0
                       for a, bt in zip(args, batched)]
            return nbytes_of(*args, pout, phit), \
                lambda st: kernel.launch_batched(
                    args[0].data_ptr(), strides[0], args[1].data_ptr(),
                    strides[1], args[2].data_ptr(), strides[2],
                    pout.data_ptr(), phit.data_ptr(), p, b, c, d,
                    torch.int32, st)
        calls.append(dict(shape=dict(b=b, c=c, d=d,
                                     shared_rows=bool(shared)),
                          single_device_us=single_us,
                          batched=batched_times(single_us, launch_for)))
    return n_cases, max_err, calls


def np_take(tree, i):
    """Point ``i`` of a tree of numpy arrays (other leaves dropped to
    None)."""
    if isinstance(tree, np.ndarray):
        return tree[i]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(np_take(v, i) for v in tree))
    if isinstance(tree, tuple):
        return tuple(np_take(v, i) for v in tree)
    return None


def periods_of(updates):
    """Chunks' period updates (numpy ``TracedUpdate`` leaves ``[n_periods,
    ...]``) as one, the periods in order."""
    return type(updates[0])(*(np.concatenate(x) for x in zip(*updates)))


def same_traces(got, want, label):
    """Two dicts of numpy traces equal in every key, dtype included."""
    if set(got) != set(want):
        raise AssertionError(f"{label}: traces {sorted(got)} against "
                             f"{sorted(want)}")
    for k, v in want.items():
        if got[k].dtype != v.dtype or not np.array_equal(got[k], v):
            raise AssertionError(f"{label}: trace {k} differs")
    return len(want)


def fleet_no_sync(cell, fleet, period_w=None):
    """:func:`no_sync` of a fleet: 8 fleet windows (a fleet period),
    eager then graphed, each under ``set_sync_debug_mode("error")``."""
    def run():
        if period_w:
            fleet.chunk.controller_chunk(
                fleet._wl, fleet.carry,
                [c.active_size for c in fleet.controllers],
                fleet.controllers[0].cfg, 1, period_w)
        else:
            fleet.chunk(fleet._wl, fleet.carry, 8)

    for graphs in (False, True):
        fleet.chunk.graphs = graphs
        run()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    fleet.chunk.graphs = True
    phase("no_sync", cell=cell, points=fleet.n_points,
          windows=period_w or 8, period=bool(period_w), eager=True,
          graphed=True)


def timed_run(fn):
    """``(result, wall s)`` of ``fn()`` ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fleet_rates(n_win, wall, capture_s, p, serial_wps, busy):
    """A fleet run's rates, the run's graph captures taken out: fleet
    windows/s, point-windows/s (P x) beside the serial racks' windows/s
    (their median, captures taken out too), and :func:`rates`' device
    share; ``wall_seconds`` keeps the captures."""
    run_s = max(wall - capture_s, 1e-9)
    r = rates(n_win, run_s, busy)
    wps = n_win / run_s
    serial = float(np.median(serial_wps))
    return dict(r, wall_seconds=round(wall, 3), capture_seconds=capture_s,
                point_windows_per_s=p * wps, serial_windows_per_s=serial,
                serial_windows_per_s_each=serial_wps,
                point_windows_over_serial=p * wps / serial)


def run_fleet_staircase(dev):
    """``fleet_staircase`` (module docstring): returns the subround
    launches of its run."""
    from repro_torch import kernels as kn
    from repro_torch.configs.orbitcache_paper import RACK, WORKLOAD
    from repro_torch.interop import to_numpy
    from repro_torch.kvstore.fleet import BatchedRackSimulator
    from repro_torch.kvstore.simulator import RackSimulator
    from repro_torch.kvstore.workload import Workload

    p = len(STAIRCASE_LOADS)
    wl = Workload(WORKLOAD, device=dev)
    t0 = time.perf_counter()
    fleet = BatchedRackSimulator(RACK, wl, offered_rps=STAIRCASE_LOADS,
                                 seeds=range(p))
    fleet.preload()
    fleet.reset_stats()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    start = clone_tree(fleet.carry)
    state = fleet.carry.draws.get_state()
    with counting_plain_versions() as plain_calls:
        kn.reset_launch_counts()
        cap0 = fleet.chunk.capture_seconds
        res, wall = timed_run(lambda: fleet.run(STAIRCASE_S))
        capture_s = fleet.chunk.capture_seconds - cap0
        launches = dict(kn.LAUNCHES)
        calls = dict(plain_calls)
    n_win = len(res[0].traces["tx"])
    if launches != dict(subround=RACK.subrounds * n_win, cms=0,
                        hot_gather=0, orbit_match=0) or any(calls.values()):
        raise AssertionError(f"fleet staircase launched {launches} and ran "
                             f"plain versions {calls} in {n_win} windows; "
                             f"want {RACK.subrounds} subround a window")
    fleet_carry = to_numpy(fleet.carry)
    rows = [stair_row(r) for r in res]
    knee = knee_of(rows)
    if not all(r["rx"] > 0 for r in rows):
        raise AssertionError("a staircase point served nothing")

    # each point against a serial graphed rack of its seed and load
    serial_wps, n_leaves, n_traces = [], 0, 0
    for i, load in enumerate(STAIRCASE_LOADS):
        sim = RackSimulator(dataclasses.replace(RACK, seed=i), wl)
        sim.set_offered(load)
        sim.preload(wl.hottest_keys(RACK.cache_entries))
        sim.reset_stats()
        cap0 = sim.chunk.capture_seconds
        r, w = timed_run(lambda: sim.run(STAIRCASE_S))
        serial_wps.append(n_win / (w - (sim.chunk.capture_seconds - cap0)))
        n_traces += same_traces(res[i].traces, r.traces, f"staircase {i}")
        n_leaves += compare_trees(np_take(fleet_carry, i),
                                  to_numpy(sim.carry), f"staircase {i}")
        del sim

    def rewind():
        fleet.carry = clone_tree(start)
        fleet.carry.draws.set_state(state)

    def drive():
        return [fleet.run_windows(FLEET_CHECK_WINDOWS)]

    wall_g, wall_e, n_ge, n_out, graphed = graphed_and_eager(
        "fleet_staircase", fleet, drive, rewind)
    with counting_plain_versions() as plain_calls:
        wall_ref, n_ref, n_out_ref = plain_replay("fleet_staircase", fleet,
                                                  drive, rewind, graphed)
    if plain_calls["subround"] != RACK.subrounds * FLEET_CHECK_WINDOWS * p:
        raise AssertionError(f"staircase plain replay ran {plain_calls}")
    rewind()
    busy = busy_per_window(lambda: fleet.run_windows(PROFILE_WINDOWS),
                           PROFILE_WINDOWS)
    phase("fleet_staircase", points=p, windows=n_win,
          offered_rps=list(STAIRCASE_LOADS), seeds=list(range(p)),
          setup_seconds=round(setup_s, 3), launches=launches,
          launches_per_fleet_window=launches["subround"] / n_win,
          points_equal_serial=p, equal_traces=n_traces,
          equal_leaves=n_leaves,
          rows=[dict(point=i, **{k: r[k] for k in
                                 ("offered", "rx", "loss", "srv_drop",
                                  "p99")})
                for i, r in enumerate(rows)],
          knee_rps=knee,
          **fleet_rates(n_win, wall, capture_s, p, serial_wps, busy),
          graph=graph_stats(fleet),
          peak_device_mib=round(torch.cuda.max_memory_allocated(dev)
                                / 2**20, 1))
    phase("fleet_replays", cell="fleet_staircase",
          windows=FLEET_CHECK_WINDOWS, graphed_seconds=round(wall_g, 3),
          eager_seconds=round(wall_e, 3),
          graphed_equal_eager_leaves=n_ge, equal_outputs=n_out,
          plain_seconds=round(wall_ref, 3), plain_equal_leaves=n_ref,
          plain_equal_outputs=n_out_ref)
    fleet_no_sync("fleet_staircase", fleet)
    return launches["subround"]


def stair_row(res, burn_frac=0.3):
    """``benchmarks/common.py::_row``'s numbers of one point."""
    rx = res.throughput_rps(burn_frac=burn_frac)
    tx = res.offered_rps(burn_frac=burn_frac)
    return dict(offered=tx, rx=rx, loss=1.0 - rx / max(tx, 1.0),
                srv_drop=res.max_server_drop_frac(burn_frac=burn_frac),
                p99=res.latency_percentile(0.99))


def knee_of(rows, loss_tol=0.02, srv_drop_tol=0.05):
    """``benchmarks/common.py::_knee_of``: the largest rx with loss and
    the worst server's drop share within their bounds."""
    ok = [r["rx"] for r in rows
          if r["loss"] <= loss_tol and r["srv_drop"] <= srv_drop_tol]
    return max(ok) if ok else rows[0]["rx"]


def run_fleet_control_plane(dev):
    """``fleet_control_plane`` (module docstring): returns the launches of
    its run."""
    from repro_torch import kernels as kn
    from repro_torch.configs.orbitcache_paper import RACK, WORKLOAD
    from repro_torch.interop import to_numpy
    from repro_torch.kvstore.fleet import BatchedRackSimulator
    from repro_torch.kvstore.simulator import RackSimulator
    from repro_torch.kvstore.workload import Workload

    p = FLEET_CP_POINTS
    rack = dataclasses.replace(RACK, track_popularity=True)
    wl = Workload(WORKLOAD, device=dev)
    fleet = BatchedRackSimulator(rack, wl, seeds=range(p))
    fleet.preload()
    period_w = int(round(CP_PERIOD_S / (rack.window_us * 1e-6)))
    start = clone_tree(fleet.carry)
    state = fleet.carry.draws.get_state()
    act0, perm0 = [c.active_size for c in fleet.controllers], \
        wl._perm_np.copy()
    updates = []
    run_periods = fleet.run_periods

    def recorded(n_periods, pw):       # every chunk's period updates
        out = run_periods(n_periods, pw)
        updates.append(fleet._last_update)
        return out
    fleet.run_periods = recorded

    def drive(phase_s=CP_PHASE_S):
        results = []
        for ph in range(CP_PHASES):
            if ph:
                wl.hot_in_swap(CP_SWAP)
                fleet.refresh_workloads()
            results.append(fleet.run(phase_s,
                                     controller_period_s=CP_PERIOD_S))
        return results

    def rewind():
        fleet.carry = clone_tree(start)
        fleet.carry.draws.set_state(state)
        for c, a in zip(fleet.controllers, act0):
            c.active_size = a
        wl._perm_np[:] = perm0
        wl.perm = torch.from_numpy(perm0.copy()).to(dev)
        fleet.refresh_workloads()
        updates.clear()

    n_win = CP_PHASES * int(round(CP_PHASE_S / (rack.window_us * 1e-6)))
    n_periods = n_win // period_w
    want = dict(subround=rack.subrounds * n_win, cms=n_win,
                hot_gather=3 * n_periods, orbit_match=0)
    with counting_plain_versions() as plain_calls:
        kn.reset_launch_counts()
        cap0 = fleet.chunk.capture_seconds
        results, wall = timed_run(drive)
        capture_s = fleet.chunk.capture_seconds - cap0
        launches, calls = dict(kn.LAUNCHES), dict(plain_calls)
    if launches != want or any(calls.values()) or \
            sum(u.n_insert.shape[1] for u in updates) != n_periods:
        raise AssertionError(f"fleet control plane launched {launches} and "
                             f"ran plain versions {calls}; want {want}")
    fleet_carry = to_numpy(fleet.carry)
    fleet_updates = list(updates)
    act = [c.active_size for c in fleet.controllers]
    win_s = rack.window_us * 1e-6

    def late_rps(traces):
        rx = (traces["rx_switch"].astype(np.int64)
              + traces["rx_server"].astype(np.int64))
        q = len(rx) // 4
        return float(rx[-q:].sum() / (q * win_s))

    per_point = []
    for i in range(p):
        late = [late_rps(r[i].traces) for r in results]
        per_point.append(dict(point=i, seed=i, late_rps=late,
                              recovery=min(late[1:]) / max(late[0], 1.0),
                              active_size=act[i]))
    if not all(min(x["late_rps"]) > 0 for x in per_point):
        raise AssertionError("a control-plane point served nothing")

    # each point against the serial control-plane rack of its seed
    serial_wps, n_leaves, n_traces, n_upd = [], 0, 0, 0
    for i in range(p):
        wl._perm_np[:] = perm0
        wl.perm = torch.from_numpy(perm0.copy()).to(dev)
        sim = RackSimulator(dataclasses.replace(rack, seed=i), wl)
        sim.preload(wl.hottest_keys(rack.cache_entries))
        s_updates = []
        cap0 = sim.chunk.capture_seconds

        def serial_drive():
            out = []
            for ph in range(CP_PHASES):
                if ph:
                    wl.hot_in_swap(CP_SWAP)
                out.append(sim.run(
                    CP_PHASE_S, controller_period_s=CP_PERIOD_S,
                    on_period=lambda s, w: s_updates.append(s._last_update)))
            return out
        s_res, w = timed_run(serial_drive)
        serial_wps.append(n_win / (w - (sim.chunk.capture_seconds - cap0)))
        for ph in range(CP_PHASES):
            n_traces += same_traces(results[ph][i].traces, s_res[ph].traces,
                                    f"cp {i} phase {ph}")
        n_upd += compare_trees(
            periods_of([np_take(u, i) for u in fleet_updates]),
            periods_of(s_updates), f"cp {i} period updates")
        n_leaves += compare_trees(np_take(fleet_carry, i),
                                  to_numpy(sim.carry), f"cp {i} carry")
        if sim.controller.active_size != act[i]:
            raise AssertionError(f"cp point {i}: active_size differs")
        del sim
    wl._perm_np[:] = perm0
    wl.perm = torch.from_numpy(perm0.copy()).to(dev)

    def one_period():
        out = fleet.run_periods(1, period_w)
        return [out, fleet._last_update._asdict(),
                dict(active=np.array([c.active_size
                                      for c in fleet.controllers]))]

    wall_g, wall_e, n_ge, n_out, graphed = graphed_and_eager(
        "fleet_control_plane", fleet, one_period, rewind)
    with counting_plain_versions() as plain_calls:
        wall_ref, n_ref, n_out_ref = plain_replay(
            "fleet_control_plane", fleet, one_period, rewind, graphed)
    want_plain = (rack.subrounds * period_w * p, period_w * p, 3 * p)
    if (plain_calls["subround"], plain_calls["cms"],
            plain_calls["hot_gather"]) != want_plain:
        raise AssertionError(f"fleet period plain replay ran {plain_calls}")
    rewind()
    busy = busy_per_window(
        lambda: fleet.run_periods(1, PROFILE_WINDOWS), PROFILE_WINDOWS)
    phase("fleet_control_plane", points=p, seeds=list(range(p)),
          windows=n_win, periods=n_periods, launches=launches,
          launches_per_fleet_window=dict(
              subround=launches["subround"] / n_win,
              cms=launches["cms"] / n_win),
          hot_gather_per_period=launches["hot_gather"] / n_periods,
          points_equal_serial=p, equal_traces=n_traces,
          equal_leaves=n_leaves, equal_update_leaves=n_upd,
          per_point=per_point,
          **fleet_rates(n_win, wall, capture_s, p, serial_wps, busy),
          graph=graph_stats(fleet),
          peak_device_mib=round(torch.cuda.max_memory_allocated(dev)
                                / 2**20, 1))
    phase("fleet_replays", cell="fleet_control_plane", windows=period_w,
          periods=1, graphed_seconds=round(wall_g, 3),
          eager_seconds=round(wall_e, 3), graphed_equal_eager_leaves=n_ge,
          equal_outputs=n_out, plain_seconds=round(wall_ref, 3),
          plain_equal_leaves=n_ref, plain_equal_outputs=n_out_ref)
    rewind()
    fleet_no_sync("fleet_control_plane", fleet, period_w)
    fleet.run_periods = run_periods
    return launches


def run_fleet_skew(dev, held=None):
    """``fleet_skew`` (module docstring): returns the subround launches of
    its OrbitCache run.  ``held`` (a dict) gets the points whose
    invariants held."""
    from repro_torch import kernels as kn
    from repro_torch.configs.orbitcache_paper import RACK, WORKLOAD
    from repro_torch.interop import to_numpy
    from repro_torch.kvstore.fleet import BatchedRackSimulator
    from repro_torch.kvstore.simulator import RackSimulator
    from repro_torch.kvstore.workload import Workload

    p = len(SKEW_ALPHAS)
    wls = [Workload(dataclasses.replace(WORKLOAD, zipf_alpha=a), device=dev)
           for a in SKEW_ALPHAS]
    sub_launches = 0
    for scheme in ("orbitcache", "netcache", "nocache"):
        rack = dataclasses.replace(RACK, scheme=scheme)
        k = rack.cache_entries if scheme == "orbitcache" else \
            rack.netcache_entries
        keys = [w.hottest_keys(k) for w in wls]
        fleet = BatchedRackSimulator(rack, wls, seeds=range(p))
        if fleet._wl_axes != (0, None, None):
            raise AssertionError(f"skew fleet axes {fleet._wl_axes}")
        fleet.preload(keys)
        before = clone_tree(fleet.carry)
        with counting_plain_versions() as plain_calls:
            kn.reset_launch_counts()
            cap0 = fleet.chunk.capture_seconds
            res, wall = timed_run(lambda: fleet.run(SKEW_S))
            capture_s = fleet.chunk.capture_seconds - cap0
            launches, calls = dict(kn.LAUNCHES), dict(plain_calls)
        n_held = check_rack(rack, fleet.carry, before, f"skew {scheme}")
        if held is not None:
            held[f"fleet_skew_{scheme}_points"] = n_held
        del before
        n_win = len(res[0].traces["tx"])
        want = dict(subround=rack.subrounds * n_win * (scheme == "orbitcache"),
                    cms=0, hot_gather=0, orbit_match=0)
        if launches != want or any(calls.values()):
            raise AssertionError(f"skew {scheme} launched {launches} and ran "
                                 f"plain versions {calls}; want {want}")
        sub_launches += launches["subround"]
        if scheme == "netcache" and not min(fleet._installed) > 0:
            raise AssertionError(f"skew netcache installed "
                                 f"{fleet._installed}")
        fleet_carry = to_numpy(fleet.carry)
        serial_wps, n_leaves, n_traces = [], 0, 0
        for i, w in enumerate(wls):
            sim = RackSimulator(dataclasses.replace(rack, seed=i), w)
            if scheme != "nocache":
                sim.preload(keys[i])
            cap0 = sim.chunk.capture_seconds
            r, wall_s = timed_run(lambda: sim.run(SKEW_S))
            serial_wps.append(n_win / (wall_s - (sim.chunk.capture_seconds
                                                 - cap0)))
            n_traces += same_traces(res[i].traces, r.traces,
                                    f"skew {scheme} {i}")
            n_leaves += compare_trees(np_take(fleet_carry, i),
                                      to_numpy(sim.carry),
                                      f"skew {scheme} {i}")
            del sim
        busy = busy_per_window(lambda: fleet.run_windows(PROFILE_WINDOWS),
                               PROFILE_WINDOWS)
        pts = []
        for i, r in enumerate(res):
            rx_sw = r.traces["rx_switch"].astype(np.int64).sum()
            rx_srv = r.traces["rx_server"].astype(np.int64).sum()
            pts.append(dict(zipf_alpha=SKEW_ALPHAS[i],
                            throughput_rps=r.throughput_rps(),
                            switch_share=float(rx_sw / max(rx_sw + rx_srv,
                                                           1)),
                            balancing_efficiency=r.balancing_efficiency(),
                            p99_us=r.latency_percentile(0.99)))
        phase("fleet_skew", scheme=scheme, points=p, windows=n_win,
              launches=launches,
              points_equal_serial=p, equal_traces=n_traces,
              equal_leaves=n_leaves, invariants_held_points=n_held,
              per_point=pts,
              installed=getattr(fleet, "_installed", None),
              **fleet_rates(n_win, wall, capture_s, p, serial_wps, busy),
              graph=graph_stats(fleet))
        del fleet
    return sub_launches


def run_fleet(dev, held=None):
    """The batched kernels against their plain versions, then the three
    fleet cells: ``(kernel records, launches by kernel and path)``
    (``held``: see :func:`run_fleet_skew`)."""
    n_sr, err_sr, t_sr = check_subround_batched(dev)
    phase("subround_batched_vs_plain", cases=n_sr, equal=True,
          max_abs_err=err_sr, **t_sr)
    n_cms, err_cms, t_cms = check_cms_batched(dev)
    phase("cms_batched_vs_plain", cases=n_cms, equal=True,
          max_abs_err=err_cms, **t_cms)
    n_hg, err_hg, t_hg = check_hot_gather_batched(dev)
    phase("hot_gather_batched_vs_plain", cases=n_hg, equal=True,
          max_abs_err=err_hg, calls=t_hg)
    stair = run_fleet_staircase(dev)
    cp = run_fleet_control_plane(dev)
    skew = run_fleet_skew(dev, held)
    by_path = dict(subround=dict(fleet_staircase=stair,
                                 fleet_control_plane=cp["subround"],
                                 fleet_skew=skew),
                   cms=dict(fleet_staircase=0,
                            fleet_control_plane=cp["cms"], fleet_skew=0),
                   hot_gather=dict(fleet_staircase=0,
                                   fleet_control_plane=cp["hot_gather"],
                                   fleet_skew=0))
    batched = dict(
        subround=(err_sr, {r["p"]: r["device_us"] for r in t_sr["batched"]}),
        cms=(err_cms, {r["p"]: r["device_us"] for r in t_cms["batched"]}),
        hot_gather=(err_hg, {r["p"]: r["device_us"]
                             for r in t_hg[1]["batched"]}))
    return batched, by_path


# --------------------------------------------------------------------------
# the spine fabric
# --------------------------------------------------------------------------
FABRIC_S, FABRIC_PERIOD_S = 0.05, 0.01   # fabric_paper: 500 windows, 5 periods
FABRIC_LOCAL_WINDOWS = 64     # locality 1.0 against independent racks
FABRIC_CHECK_PERIOD_W = 25    # graphed = eager = plain, one period of these
FABRIC_NESTED = (3, 4)        # points x racks of the nested kernel checks
# (b, c, s, f, j) of the paper fabric's rack (352 + 32 forward lanes) and
# spine (256 spine lanes over 4 subrounds, 256 entries) subround calls
FABRIC_RACK_SR = (384, 128, 8, 1, 8)
FABRIC_SPINE_SR = (64, 256, 8, 1, 8)
FABRIC_CMS = (32, 1536, 2048)   # a rack's sketches over its 1,536 lanes
# the spine controller's _merge_scores shapes: 256 entries against the
# R x 32 servers x 16 reported ids
FABRIC_HG = ((256, 2048, 1), (2048, 2048, 1), (2048, 256, 1))
LOCALITIES = (1.0, 0.9, 0.5)    # benchmarks/fabric_locality.py, full run
LOCALITY_WINDOWS, LOCALITY_WARM, LOCALITY_PERIOD_W = 256, 16, 16


def nested(fn, args, dims):
    """``fn`` under two vmap levels (points, then racks): ``dims[k]`` is
    ``(outer, inner)``, each 0 or None."""
    def inner(*xs):
        return torch.func.vmap(fn, in_dims=tuple(d[1] for d in dims))(*xs)
    return torch.func.vmap(inner, in_dims=tuple(d[0] for d in dims))(*args)


def nested_args(make, q, p, dims):
    """Inputs of a nested call: ``make(i, j)`` per (point, rack), stacked
    where batched (a shared level takes index 0's)."""
    per = [[make(i, j) for j in range(p)] for i in range(q)]

    def level(k, i):
        row = [per[i][j][k] for j in range(p)]
        return torch.stack(row) if dims[k][1] == 0 else row[0]
    return [torch.stack([level(k, i) for i in range(q)])
            if dims[k][0] == 0 else level(k, 0) for k in range(len(dims))]


def nested_point(args, dims, i, j):
    out = []
    for a, (do, di) in zip(args, dims):
        a = a[i] if do == 0 else a
        out.append(a[j] if di == 0 else a)
    return out


def check_fabric_kernels(dev):
    """The fabric's launches of the kernels (module docstring, phase 13):
    ``subround`` and ``cms`` under two vmap levels (3 points x 4 racks,
    inputs batched at both, or the tables shared over the racks and
    expanded), ``subround`` at 3 spines of 256 entries, each one launch
    and equal to its plain version per point, timed beside P x the single
    launch; the spine controller's ``hot_gather`` shapes, timed."""
    from repro_torch import kernels as kn
    from repro_torch.kernels.cms import kernel as cms_kernel
    from repro_torch.kernels.cms.ops import (
        tile_for, update_query, update_query_batched,
    )
    from repro_torch.kernels.cms.ref import cms_update_query_fast
    from repro_torch.kernels.hot_gather.ref import hot_gather_ref
    from repro_torch.kernels.subround import kernel as sr_kernel
    from repro_torch.kernels.subround.ops import subround, subround_batched
    from repro_torch.kernels.subround.ref import subround_ref

    q, r = FABRIC_NESTED
    max_err, cases, out = 0.0, 0, {}

    def sr_tensors(seed, shape):
        b, c, s, f, _ = shape
        return [torch.from_numpy(np.array(a)).to(dev)
                for a in subround_case(seed, b, c, s, f, budget=1000)]

    def same(got, want, label):
        nonlocal max_err
        for g, w in zip(got, want):
            max_err = max(max_err, max_abs_err(g, w))
            if not torch.equal(g, w):
                raise AssertionError(f"{label}: kernel != plain version")

    def sr_times(shape, p):
        b, c, s, f, j = shape
        one = sr_tensors(7, shape)
        outs = subround(*one, s, f, j)
        ptrs = ([a.data_ptr() for a in one[:-1]]
                + [one[-1].reshape(1).data_ptr()]
                + [o.data_ptr() for o in outs])
        single, _ = device_timed(
            lambda st: sr_kernel.launch(ptrs, b, c, s, f, j, st))
        args, _ = stack_points([sr_tensors(7 + i, shape) for i in range(p)],
                               ())
        got = subround_batched(args, [True] * 31, p, s, f, j)
        bptrs = [a.data_ptr() for a in args] + [o.data_ptr() for o in got]
        strides = [a[0].numel() for a in args] + [o[0].numel() for o in got]
        us, method = device_timed(
            lambda st, held=(args, got): sr_kernel.launch_batched(
                bptrs, strides, p, b, c, s, f, j, st))
        return dict(shape=dict(zip("bcsfj", shape)), p=p,
                    single_device_us=single, device_us=us,
                    device_timing=method, p_x_single_us=p * single,
                    **bound(nbytes_of(*args, *got), p * b * c * 5))

    # subround, racks: 3 points x 4 racks, one launch of 12 blocks
    b, c, s, f, j = FABRIC_RACK_SR
    for shared in (False, True):
        dims = ([(0, 0)] * 12 + [(0, None) if shared else (0, 0)] * 18
                + [(0, 0)])
        args = nested_args(lambda i, k: sr_tensors(9100 + 10 * i + k,
                                                   FABRIC_RACK_SR), q, r,
                           dims)
        kn.reset_launch_counts()
        got = nested(lambda *a: tuple(kn.subround(*a, queue_size=s,
                                                  max_frags=f,
                                                  max_serves=j)),
                     args, dims)
        if kn.LAUNCHES["subround"] != 1:
            raise AssertionError(f"nested subround launched "
                                 f"{kn.LAUNCHES['subround']} times")
        for i in range(q):
            for k in range(r):
                same([g[i, k] for g in got], subround_ref(
                    *nested_point(args, dims, i, k), queue_size=s,
                    max_frags=f, max_serves=j), f"nested subround {i},{k}")
                cases += 1
    out["subround_racks"] = sr_times(FABRIC_RACK_SR, q * r)

    # subround, spines: 3 points of C = 256, one launch of 3 blocks
    b, c, s, f, j = FABRIC_SPINE_SR
    per = [sr_tensors(9200 + i, FABRIC_SPINE_SR) for i in range(q)]
    args, _ = stack_points(per, ())
    kn.reset_launch_counts()
    got = torch.func.vmap(lambda *a: tuple(kn.subround(
        *a, queue_size=s, max_frags=f, max_serves=j)))(*args)
    if kn.LAUNCHES["subround"] != 1:
        raise AssertionError("batched spine subround launched "
                             f"{kn.LAUNCHES['subround']} times")
    for i in range(q):
        same([g[i] for g in got], subround_ref(*per[i], queue_size=s,
                                                max_frags=f, max_serves=j),
             f"spine subround {i}")
        cases += 1
    out["subround_spines"] = sr_times(FABRIC_SPINE_SR, q)

    # count-min: 3 points x 4 racks x 32 sketches, one launch
    n, b, w = FABRIC_CMS
    tile = tile_for(b)
    hk_of = {}

    def cms_args(i, k):
        from repro_torch.core.hashing import hash128_u32_np
        rng = np.random.default_rng(9300 + 10 * i + k)
        keys = rng.integers(0, 2 * b + 4, b).astype(np.int32)
        hk = torch.from_numpy(hash128_u32_np(keys).view(np.int32)).to(dev)
        mask = torch.from_numpy(rng.random((n, b)) < 1 / 32).to(dev)
        counts = torch.from_numpy(rng.integers(0, 51, (n, 5, w))
                                  .astype(np.int32)).to(dev)
        hk_of[(i, k)] = hk
        return [hk, mask, counts]
    dims = [(0, 0)] * 3
    args = nested_args(cms_args, q, r, dims)
    kn.reset_launch_counts()
    got = nested(lambda h, m, cnt: kn.cms_update_query(h, m, cnt), args,
                 dims)
    if kn.LAUNCHES["cms"] != 1:
        raise AssertionError(f"nested cms launched {kn.LAUNCHES['cms']} "
                             f"times")
    from repro_torch.kernels.cms.ops import rows_for
    for i in range(q):
        for k in range(r):
            h, m, cnt = nested_point(args, dims, i, k)
            same([g[i, k] for g in got], cms_update_query_fast(
                rows_for(h, w), m.to(torch.int32), cnt, block_b=tile),
                f"nested cms {i},{k}")
            cases += 1
    idx, mask, counts = cms_case(7, n, b, w, 1 / 32, dev)
    o1, e1 = update_query(idx, mask, counts, tile)
    single, _ = device_timed(lambda st: cms_kernel.launch(
        idx.data_ptr(), mask.data_ptr(), counts.data_ptr(), o1.data_ptr(),
        e1.data_ptr(), n, b, w, tile, st))
    p = q * r
    (pidx, pmask, pcounts), _ = stack_points(
        [cms_case(7 + i, n, b, w, 1 / 32, dev) for i in range(p)], ())
    pout, pest = update_query_batched(pidx, pmask, pcounts, tile)
    us, method = device_timed(lambda st: cms_kernel.launch_batched(
        pidx.data_ptr(), b * 5, n, pmask.data_ptr(), pcounts.data_ptr(),
        pout.data_ptr(), pest.data_ptr(), p * n, b, w, tile, st))
    out["cms_racks"] = dict(shape=dict(n=n, b=b, w=w), p=p,
                            single_device_us=single, device_us=us,
                            device_timing=method, p_x_single_us=p * single,
                            **bound(nbytes_of(pidx, pmask, pcounts, pout,
                                              pest), 0))

    # hot_gather at the spine controller's three shapes
    calls = []
    for hb, hc, hd in FABRIC_HG:
        ids, hot, rows = hg_case(hb + hc + 1, hb, hc, hd, torch.int32, True,
                                 dev)
        same(kn.hot_gather(ids, hot, rows), hot_gather_ref(ids, hot, rows),
             f"spine hot_gather {hb}x{hc}")
        cases += 1
        calls.append(dict(shape=dict(b=hb, c=hc, d=hd),
                          **hg_kernel_times(ids, hot, rows),
                          **hg_bound(ids, hot, rows)))
    out["hot_gather_spine"] = calls
    return cases, max_err, out


def fabric_active(sim):
    """``(active sizes, controller configs)`` a fabric's chunk takes, for
    a serial or a batched fabric."""
    if hasattr(sim, "spine_controller"):
        return (([c.active_size for c in sim.controllers],
                 sim.spine_controller.active_size),
                (sim.controllers[0].cfg, sim.spine_controller.cfg))
    return (([[c.active_size for c in cs] for cs in sim.controllers],
             [s.active_size for s in sim.spine_controllers]),
            (sim.controllers[0][0].cfg, sim.spine_controllers[0].cfg))


def fabric_no_sync(cell, sim, period_w=None):
    """:func:`no_sync` of a fabric (serial or batched): 8 windows, or a
    period of ``period_w``, eager then graphed, each under
    ``set_sync_debug_mode("error")``."""
    wl = sim.wl.arrays

    def run():
        if period_w:
            active, cfgs = fabric_active(sim)
            sim.chunk.controller_chunk(wl, sim.carry, active, cfgs, 1,
                                       period_w)
        else:
            sim.chunk(wl, sim.carry, 8)

    for graphs in (False, True):
        sim.chunk.graphs = graphs
        run()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    sim.chunk.graphs = True
    phase("no_sync", cell=cell, windows=period_w or 8,
          period=bool(period_w), eager=True, graphed=True)


def spine_merge_inputs(sim, period_w):
    """The three ``(ids, hot, rows)`` input sets of the spine controller's
    ``_merge_scores`` in one period of ``sim`` (the calls that are not
    batched over the racks), recorded through the dispatcher."""
    from repro_torch import kernels as kn

    recorded, real = [], kn.hot_gather

    def record(*args):
        if not kn._batched(*args):
            recorded.append([a.clone() for a in args])
        return real(*args)

    kn.hot_gather = record
    sim.chunk.graphs = False        # a graph would replay past the recorder
    try:
        sim.run_periods(1, period_w)
    finally:
        kn.hot_gather = real
        sim.chunk.graphs = True
    if len(recorded) != 3:
        raise AssertionError(f"{len(recorded)} spine hot_gather calls in a "
                             f"period")
    return recorded


def run_fabric_paper(dev, held=None):
    """``fabric_paper`` (module docstring, phase 14): returns the launches
    of its run.  ``held`` (a dict) gets the racks whose invariants
    held."""
    from repro_torch import kernels as kn
    from repro_torch.configs.orbitcache_paper import RACK, WORKLOAD
    from repro_torch.interop import to_numpy
    from repro_torch.kernels.hot_gather.ref import hot_gather_ref
    from repro_torch.kvstore.fabric_sim import FabricConfig, FabricSimulator
    from repro_torch.kvstore.simulator import RackSimulator
    from repro_torch.kvstore.workload import Workload

    rack = dataclasses.replace(RACK, track_popularity=True)
    fcfg = FabricConfig()
    r_fab = fcfg.n_racks
    wl = Workload(WORKLOAD, device=dev)
    t0 = time.perf_counter()
    sim = FabricSimulator(rack, fcfg, wl)
    sim.preload()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    start, state = clone_tree(sim.carry), sim.carry.draws.get_state()
    period_w = int(round(FABRIC_PERIOD_S / (rack.window_us * 1e-6)))

    def rewind():
        sim.carry = clone_tree(start)
        sim.carry.draws.set_state(state)
        for c in sim.controllers:
            c.active_size = rack.cache_entries
        sim.spine_controller.active_size = fcfg.spine_cache_entries

    with counting_plain_versions() as plain_calls:
        kn.reset_launch_counts()
        cap0 = sim.chunk.capture_seconds
        res, wall = timed_run(lambda: sim.run(
            FABRIC_S, controller_period_s=FABRIC_PERIOD_S))
        capture_s = sim.chunk.capture_seconds - cap0
        launches, calls = dict(kn.LAUNCHES), dict(plain_calls)
    sp = res.spine
    n_win = len(sp["remote"])
    n_periods = n_win // period_w
    want = dict(subround=2 * rack.subrounds * n_win, cms=n_win,
                hot_gather=6 * n_periods, orbit_match=0)
    if launches != want or any(calls.values()):
        raise AssertionError(f"fabric_paper launched {launches} and ran "
                             f"plain versions {calls}; want {want}")
    # the post-window invariants of every rack and of the spine (periods
    # reset the switches' popularity: the servers against the preload)
    from repro_torch.analysis.invariants import check_switch_invariants
    n_held = check_rack(rack, sim.carry.racks, start.racks, "fabric racks",
                        period=True)
    check_switch_invariants(sim.carry.spine, None, "fabric spine")
    if held is not None:
        held["fabric_paper_racks"] = n_held
        held["fabric_paper_spines"] = 1
    # the conservation law of an OrbitCache spine, per window, and every
    # spine serve accounted at the spine tier
    remote, served, fwd, in_drops = (sp[k].astype(np.int64) for k in (
        "remote", "served", "fwd", "in_drops"))
    rx0 = int(start.spine_clients.rx_switch)
    queue_cap = fcfg.spine_cache_entries * fcfg.spine_queue_size
    if not ((fwd + in_drops <= remote).all()
            and served.sum() <= remote.sum() + queue_cap
            and served.sum() == sp["rx_switch"] - rx0):
        raise AssertionError("fabric_paper: the spine's conservation law "
                             "fails")
    if not (remote.sum() > 0 and served.sum() > 0 and fwd.sum() > 0):
        raise AssertionError("fabric_paper: the spine saw no traffic")
    win_s = rack.window_us * 1e-6
    burn = int(n_win * 0.25)
    spine_rps = float(served[burn:].sum() / ((n_win - burn) * win_s))
    rack_rps = res.throughput_rps() - spine_rps
    results = dict(
        delivered_rps=res.throughput_rps(), rack_tier_rps=rack_rps,
        spine_tier_rps=spine_rps, offered_rps=res.offered_rps(),
        spine_hit_ratio=res.spine_hit_ratio(),
        spine_fwd_rps=float(fwd[burn:].sum() / ((n_win - burn) * win_s)),
        exchange_drops=int(in_drops.sum() + sp["fwd_drops"].sum()),
        spine_active_size=sp["active_size"],
        rack_active_sizes=[c.active_size for c in sim.controllers],
        p99_us_per_rack=[r.latency_percentile(0.99) for r in res.racks])

    # the spine controller's merge inputs, live: its first period's
    rewind()
    hg_live = []
    for ids, hot, rows in spine_merge_inputs(sim, period_w):
        got = kn.hot_gather(ids, hot, rows)
        want_hg = hot_gather_ref(ids, hot, rows)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want_hg)):
            raise AssertionError("spine hot_gather != plain on the live "
                                 "inputs")
        valid = hot[hot >= 0]
        hg_live.append(dict(
            shape=dict(b=ids.shape[0], c=hot.shape[0], d=rows.shape[1]),
            hot_sentinels=int((hot == -2).sum()),
            id_sentinels=int((ids == -3).sum()),
            hot_repeats=int(valid.numel() - torch.unique(valid).numel()),
            hits=int(got[1].sum()),
            **hg_kernel_times(ids, hot, rows), **hg_bound(ids, hot, rows)))
    phase("hot_gather_spine_live", equal=True, calls=hg_live)

    # locality 1.0 from the preload: rack i is the serial paper rack of
    # seed i, leaf for leaf.  Held as the reference holds it, without the
    # servers' tracking: with it, the forward lanes shift the tiles of the
    # sketch's estimates (``tracker.cand.est``), in the reference's fabric
    # as in the port's
    base = dataclasses.replace(rack, track_popularity=False)
    one = FabricSimulator(base, dataclasses.replace(fcfg, local_frac=1.0),
                          wl)
    one.preload()
    out = one.run_windows(FABRIC_LOCAL_WINDOWS)
    fab = to_numpy(one.carry)
    del one
    n_leaves = n_traces = 0
    for i in range(r_fab):
        r_sim = RackSimulator(dataclasses.replace(base, seed=i), wl)
        r_sim.preload(wl.hottest_keys(base.cache_entries))
        r_out = r_sim.run_windows(FABRIC_LOCAL_WINDOWS)
        n_traces += same_traces({k: out[f"rack_{k}"][:, i] for k in r_out},
                                r_out, f"fabric rack {i}")
        n_leaves += compare_trees(np_take(fab.racks, i)._replace(draws=None),
                                  to_numpy(r_sim.carry), f"fabric rack {i}")
        del r_sim
    if out["spine_remote"].sum() or out["spine_fwd"].sum():
        raise AssertionError("locality 1.0 sent lanes to the spine")
    phase("fabric_locality_one", racks=r_fab, windows=FABRIC_LOCAL_WINDOWS,
          racks_equal_serial=r_fab, equal_traces=n_traces,
          equal_leaves=n_leaves)

    # one period at 0.9 graphed, eager and under the plain versions
    def one_period():
        m = sim.run_periods(1, FABRIC_CHECK_PERIOD_W)
        return [m, dict(active=np.array([c.active_size
                                         for c in sim.controllers]
                                        + [sim.spine_controller
                                           .active_size]))]

    wall_g, wall_e, n_ge, n_out, graphed = graphed_and_eager(
        "fabric_paper", sim, one_period, rewind)
    with counting_plain_versions() as plain_calls:
        wall_ref, n_ref, n_out_ref = plain_replay(
            "fabric_paper", sim, one_period, rewind, graphed)
    # the plain versions run once per rack (and once for the spine)
    pw = FABRIC_CHECK_PERIOD_W
    want_plain = (rack.subrounds * pw * (r_fab + 1), pw * r_fab,
                  3 * (r_fab + 1))
    if (plain_calls["subround"], plain_calls["cms"],
            plain_calls["hot_gather"]) != want_plain:
        raise AssertionError(f"fabric plain replay ran {plain_calls}")
    phase("fabric_replays", cell="fabric_paper", windows=pw, periods=1,
          graphed_seconds=round(wall_g, 3), eager_seconds=round(wall_e, 3),
          graphed_equal_eager_leaves=n_ge, equal_outputs=n_out,
          plain_seconds=round(wall_ref, 3), plain_equal_leaves=n_ref,
          plain_equal_outputs=n_out_ref)

    # what the profiler sees of a few windows, graphed then eager (each
    # window is ~2,800 device kernels: longer stretches make the
    # profiler's own processing the longest step of the cell)
    prof_w = PROFILE_WINDOWS
    rewind()
    busy_g = busy_per_window(lambda: sim.run_windows(prof_w), prof_w)
    rewind()
    sim.chunk.graphs = False
    ev, ev_wall = device_profile(lambda: sim.run_windows(prof_w))
    sim.chunk.graphs = True
    busy_e = busy_per_window(None, prof_w, ev, ev_wall)
    by_kernel = {k: sum(e.count for e in ev if f"{k}_kernel" in e.key)
                 for k in ("subround", "cms")}
    phase("fabric_paper", racks=r_fab, windows=n_win, periods=n_periods,
          setup_seconds=round(setup_s, 3), launches=launches,
          launches_per_window=dict(subround=launches["subround"] / n_win,
                                   cms=launches["cms"] / n_win),
          hot_gather_per_period=launches["hot_gather"] / n_periods,
          eager_kernels_per_window={k: v / prof_w
                                    for k, v in by_kernel.items()},
          results=results, conservation=True,
          invariants_held=dict(racks=n_held, spine=1),
          graphed=dict(rates(n_win, wall - capture_s, busy_g),
                       wall_seconds=round(wall, 3),
                       run_capture_seconds=capture_s, **graph_stats(sim)),
          eager=rates(pw, wall_e, busy_e),
          peak_device_mib=round(torch.cuda.max_memory_allocated(dev)
                                / 2**20, 1))
    rewind()
    fabric_no_sync("fabric_paper", sim)
    rewind()
    fabric_no_sync("fabric_paper", sim, period_w=8)
    del sim
    return launches


def locality_configs(scheme, track=False):
    """``benchmarks/fabric_locality.py``'s rack and fabric, one scheme at
    both tiers."""
    from repro_torch.kvstore.fabric_sim import FabricConfig
    from repro_torch.kvstore.simulator import RackConfig

    cfg = RackConfig(scheme=scheme, cache_entries=64, num_servers=8,
                     client_batch=256, fetch_lanes=64, value_pad=256,
                     server_queue=32, subrounds=2, track_popularity=track)
    fcfg = FabricConfig(n_racks=4, spine_scheme=scheme, spine_lanes=256,
                        fwd_lanes=128, spine_cache_entries=128)
    return cfg, fcfg


def run_fabric_locality(dev):
    """``fabric_locality`` (module docstring, phase 15): returns the
    launches of its runs."""
    from repro_torch import kernels as kn
    from repro_torch.interop import to_numpy
    from repro_torch.kvstore.fabric_sim import FabricSimulator
    from repro_torch.kvstore.fleet import BatchedFabricSimulator
    from repro_torch.kvstore.workload import Workload, WorkloadConfig

    wl = Workload(WorkloadConfig(num_keys=1_000_000, offered_rps=1.0e6),
                  device=dev)
    p = len(LOCALITIES)
    total = dict.fromkeys(kn.LAUNCHES, 0)
    n = LOCALITY_WINDOWS
    for scheme in ("orbitcache", "netcache", "nocache"):
        cfg, fcfg = locality_configs(scheme)
        win_s = cfg.window_us * 1e-6
        bf = BatchedFabricSimulator(cfg, fcfg, wl, local_fracs=LOCALITIES)
        bf.preload(warm_windows=LOCALITY_WARM)
        with counting_plain_versions() as plain_calls:
            kn.reset_launch_counts()
            cap0 = bf.chunk.capture_seconds
            out, wall = timed_run(lambda: bf.run_windows(n))
            capture_s = bf.chunk.capture_seconds - cap0
            launches, calls = dict(kn.LAUNCHES), dict(plain_calls)
        want = dict(subround=2 * cfg.subrounds * n * (scheme == "orbitcache"),
                    cms=0, hot_gather=0, orbit_match=0)
        if launches != want or any(calls.values()):
            raise AssertionError(f"fabric_locality {scheme} launched "
                                 f"{launches}, plain {calls}; want {want}")
        for k in total:
            total[k] += launches[k]
        fab = to_numpy(bf.carry)
        rows = []
        for i, loc in enumerate(LOCALITIES):
            tot = lambda k: int(out[k][i].astype(np.int64).sum())
            rx = tot("rack_rx_switch") + tot("rack_rx_server")
            tx, remote, sp_rx = tot("rack_tx"), tot("spine_remote"), \
                tot("spine_served")
            rows.append(dict(
                locality=loc, delivered_rps=(rx + sp_rx) / (n * win_s),
                offered_rps=tx / (n * win_s),
                remote_frac=remote / max(tx, 1),
                spine_hit_ratio=sp_rx / max(remote, 1),
                spine_fwd_rps=tot("spine_fwd") / (n * win_s),
                drops=tot("spine_in_drops") + tot("spine_fwd_drops")))
        busy = busy_per_window(lambda: bf.run_windows(PROFILE_WINDOWS),
                               PROFILE_WINDOWS)
        # each point against a serial graphed fabric of its seed and
        # locality
        n_leaves = n_traces = 0
        serial_wps = []
        for i, loc in enumerate(LOCALITIES):
            s = FabricSimulator(dataclasses.replace(cfg, seed=1000 * i),
                                fcfg, wl)
            s.set_local_frac(loc)
            s.preload(warm_windows=LOCALITY_WARM)
            cap0 = s.chunk.capture_seconds
            s_out, s_wall = timed_run(lambda: s.run_windows(n))
            serial_wps.append(n / (s_wall - (s.chunk.capture_seconds - cap0)))
            n_traces += same_traces({k: v[i] for k, v in out.items()},
                                    s_out, f"locality {scheme} {i}")
            n_leaves += compare_trees(np_take(fab, i), to_numpy(s.carry),
                                      f"locality {scheme} {i}")
            del s
        phase("fabric_locality", scheme=scheme, points=p, racks=fcfg.n_racks,
              windows=n, localities=list(LOCALITIES), rows=rows,
              launches=launches,
              subround_per_batched_window=launches["subround"] / n,
              points_equal_serial=p, equal_traces=n_traces,
              equal_leaves=n_leaves,
              **fleet_rates(n, wall, capture_s, p, serial_wps, busy),
              graph=graph_stats(bf))
        fabric_no_sync(f"fabric_locality_{scheme}", bf)
        del bf

    # the period boundary of the sweep: OrbitCache, tracking on, one
    # period graphed, eager and under the plain versions
    cfg, fcfg = locality_configs("orbitcache", track=True)
    bf = BatchedFabricSimulator(cfg, fcfg, wl, local_fracs=LOCALITIES)
    bf.preload(warm_windows=LOCALITY_WARM)
    start, state = clone_tree(bf.carry), bf.carry.draws.get_state()
    pw = LOCALITY_PERIOD_W

    def rewind():
        bf.carry = clone_tree(start)
        bf.carry.draws.set_state(state)
        for cs in bf.controllers:
            for c in cs:
                c.active_size = cfg.cache_entries
        for sc in bf.spine_controllers:
            sc.active_size = fcfg.spine_cache_entries

    def one_period():
        m = bf.run_periods(1, pw)
        return [m, dict(active=np.array(
            [[c.active_size for c in cs] for cs in bf.controllers]),
            spine=np.array([sc.active_size for sc in bf.spine_controllers]))]

    with counting_plain_versions() as plain_calls:
        kn.reset_launch_counts()
        one_period()
        launches, calls = dict(kn.LAUNCHES), dict(plain_calls)
    want = dict(subround=2 * cfg.subrounds * pw, cms=pw, hot_gather=6,
                orbit_match=0)
    if launches != want or any(calls.values()):
        raise AssertionError(f"fabric_locality period launched {launches}, "
                             f"plain {calls}; want {want}")
    for k in total:
        total[k] += launches[k]
    wall_g, wall_e, n_ge, n_out, graphed = graphed_and_eager(
        "fabric_locality_period", bf, one_period, rewind)
    with counting_plain_versions() as plain_calls:
        wall_ref, n_ref, n_out_ref = plain_replay(
            "fabric_locality_period", bf, one_period, rewind, graphed)
    r = fcfg.n_racks
    want_plain = (cfg.subrounds * pw * p * (r + 1), pw * p * r,
                  3 * p * (r + 1))
    if (plain_calls["subround"], plain_calls["cms"],
            plain_calls["hot_gather"]) != want_plain:
        raise AssertionError(f"locality period plain replay ran "
                             f"{plain_calls}")
    phase("fabric_replays", cell="fabric_locality_period", points=p,
          windows=pw, periods=1, launches=launches,
          graphed_seconds=round(wall_g, 3), eager_seconds=round(wall_e, 3),
          graphed_equal_eager_leaves=n_ge, equal_outputs=n_out,
          plain_seconds=round(wall_ref, 3), plain_equal_leaves=n_ref,
          plain_equal_outputs=n_out_ref)
    rewind()
    fabric_no_sync("fabric_locality_period", bf, period_w=8)
    del bf
    return total


# --------------------------------------------------------------------------
# the composed switch path and the orbit ring service (phases 16-19)
# --------------------------------------------------------------------------
COMPOSED_WINDOWS = 24         # windows a scheme, fused against composed
RING_D = 8                    # tests/test_distributed_ring.py's ring
SERVICE_D = 8                 # stacked ring positions of the service
SERVICE_STEPS = 200           # Zipf steps of the service, timed
SERVICE_CPU_STEPS = 4         # its first steps, card against CPU
RING_PROCESS_STEPS = 16
SYNTH_CHUNK = 1 << 18         # keys a chunk when filling the store


def same_on_card(a, b, path):
    """Assert two trees of tensors on one device equal leaf for leaf
    (dtype, shape, values); returns the leaves compared."""
    if isinstance(a, torch.Tensor):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"differs at {path}")
        return 1
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return sum(same_on_card(x, y, f"{path}.{n}")
                   for n, x, y in zip(a._fields, a, b))
    if isinstance(a, tuple):
        return sum(same_on_card(x, y, f"{path}[{i}]")
                   for i, (x, y) in enumerate(zip(a, b)))
    return 0


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def run_composed_vs_fused(dev):
    """The fused ``window_step`` (the subround kernel) against the composed
    window of ``tests/torch_composed.py`` (plain PyTorch on the card) for
    each scheme on the paper rack, then ``switch_step`` against the
    composed seed step on the four edge cases; returns the launches."""
    import torch_composed as tc

    from repro_torch import kernels as kn
    from repro_torch.configs.orbitcache_paper import RACK, WORKLOAD
    from repro_torch.kvstore.simulator import RackSimulator
    from repro_torch.kvstore.workload import Workload

    wl = Workload(WORKLOAD, device=dev)
    launches = dict.fromkeys(kn.LAUNCHES, 0)

    def drive(label, fn, want_subround):
        with counting_plain_versions() as plain_calls:
            kn.reset_launch_counts()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got, calls = dict(kn.LAUNCHES), dict(plain_calls)
        want = dict.fromkeys(got, 0)
        want["subround"] = want_subround
        if got != want or any(calls.values()):
            raise AssertionError(f"{label}: launches {got}, plain {calls}")
        launches["subround"] += got["subround"]
        return out, wall

    for scheme in ("orbitcache", "netcache", "nocache"):
        rack = dataclasses.replace(RACK, scheme=scheme)
        sim = RackSimulator(rack, wl, device=dev)
        if scheme == "orbitcache":
            sim.preload(wl.hottest_keys(rack.cache_entries))
        elif scheme == "netcache":
            sim.preload(wl.hottest_keys(rack.netcache_entries))
        # writes on, so that invalidations and reply installs run
        sim.carry = sim.carry._replace(write_ratio=torch.tensor(
            0.1, dtype=torch.float32, device=dev))
        n_sub = rack.subrounds * COMPOSED_WINDOWS * (scheme == "orbitcache")
        (leaves, carry), wall = drive(
            scheme, lambda: tc.fused_and_composed(sim, COMPOSED_WINDOWS,
                                                  same_on_card), n_sub)
        cs = carry.clients
        phase("composed_vs_fused", scheme=scheme, windows=COMPOSED_WINDOWS,
              write_ratio=0.1, equal_leaves=leaves, subround_launches=n_sub,
              seconds=round(wall, 3), rx_switch=int(cs.rx_switch),
              rx_server=int(cs.rx_server), mismatches=int(cs.mismatches))
        if scheme != "nocache" and not int(cs.rx_switch) > 0:
            raise AssertionError(f"{scheme}: the switch served nothing")

    cases = tc.edge_cases(dev)
    n_steps = sum(len(steps) for _, steps, _ in cases.values())
    leaves, _ = drive("edge cases", lambda: sum(
        tc.run_compare(sw, steps, name, same_on_card)[1]
        for name, (sw, steps, _) in cases.items()), n_steps)
    phase("composed_vs_fused", cases=sorted(cases), steps=n_steps,
          equal_leaves=leaves, subround_launches=n_steps)
    return launches


def ring_setup(d, device):
    """The start state and packets of ``tests/test_distributed_ring.py``
    (entries 0..3 installed, position p < 4 holding entry p's line of
    byte p + 1, four reads of keys 0..3 a position) on ``d`` positions."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import lookup as lk
    from repro_torch.core.hashing import hash128_u32
    from repro_torch.core.types import OP_NONE, OP_R_REQ, PacketBatch

    c, s, l, pad, b = 16, 4, 4, 64, 8
    i32 = torch.int32
    one = dist.init_ring_state(c, s, l, pad, "cpu")
    st = dist.tree_map_dims(lambda x: x.expand((d,) + x.shape).clone(), one,
                            dist.RING_DIMS)
    keys = torch.arange(4, dtype=i32)
    valid = st.state.valid.clone()
    valid[:4] = True
    sl = st.slice
    for p in range(min(4, d)):
        sl.live[p, 0], sl.cidx[p, 0], sl.kidx[p, 0] = True, p, p
        sl.vlen[p, 0] = 32
        sl.val[p, 0, :32] = p + 1
    st = st._replace(lookup=lk.install(st.lookup, keys, hash128_u32(keys),
                                       keys),
                     state=st.state._replace(valid=valid))
    op = torch.full((d, b), OP_NONE, dtype=i32)
    op[:, :4] = OP_R_REQ
    kq = torch.zeros((d, b), dtype=i32)
    kq[:, :4] = keys
    zeros = torch.zeros((d, b), dtype=i32)
    pk = PacketBatch(
        op=op, seq=torch.arange(d * b, dtype=i32).reshape(d, b),
        hkey=hash128_u32(kq), flag=zeros, kidx=kq,
        vlen=torch.full((d, b), 32, dtype=i32), client=zeros, port=zeros,
        server=zeros, ts=torch.zeros((d, b)), valid=op == OP_R_REQ,
        val=torch.zeros((d, b, pad), dtype=torch.uint8))
    empty = PacketBatch(*(torch.zeros_like(x) for x in pk))
    return clone_tree(st, device), clone_tree(pk, device), \
        clone_tree(empty, device)


def run_ring_stacked(dev):
    """``StackedRing(8)`` on the card over a revolution from the reference
    ring test's start: equal to the same run on the CPU leaf for leaf,
    every request served once with its entry's bytes, queues drained."""
    from repro_torch import kernels as kn
    from repro_torch.core import distributed as dist
    from repro_torch.interop import to_numpy

    step = dist.make_ring_step(dist.StackedRing(RING_D), clones_per_visit=4)
    runs = []
    kn.reset_launch_counts()
    for where in (dev, torch.device("cpu")):
        st, pk, empty = ring_setup(RING_D, where)
        outs = []
        for k in range(RING_D + 1):
            st, serve = step(st, pk if k == 0 else empty)
            outs.append(to_numpy((st, serve)))
        runs.append(outs)
    if any(kn.LAUNCHES.values()):
        raise AssertionError(f"the ring launched {kn.LAUNCHES}")
    card, cpu = runs
    leaves = sum(compare_trees(a, b, f"ring step {k}")
                 for k, (a, b) in enumerate(zip(card, cpu)))
    total, wrong = 0, 0
    for st, serve in card:
        total += int(serve.served.sum())
        for c in range(4):
            hit = serve.served[:, c].any(axis=-1)
            wrong += int((serve.val[hit, c, 0] != c + 1).sum())
    qlen = int(card[-1][0].reqtab.qlen.astype(np.int64).sum())
    phase("ring_stacked", positions=RING_D, steps=RING_D + 1,
          card_equals_cpu_leaves=leaves, served=total,
          expected=RING_D * 4, wrong_value_bytes=wrong, queued_after=qlen)
    if total != RING_D * 4 or wrong or qlen:
        raise AssertionError("the ring's revolution checks failed")


def service_setup(cfg, n_keys, d, hot, device):
    """A service of ``d`` stacked positions over ``n_keys`` keys, each
    value ``synth_value(key, 0)``, with the keys ``hot`` (``d *
    slice_len`` of them) installed in entries 0.. and circulating as
    orbit lines, position p holding lines p * slice_len ..."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import lookup as lk
    from repro_torch.core.hashing import hash128_u32
    from repro_torch.kvstore.store import synth_value
    from repro_torch.serving import orbit_service as svc

    st = svc.init_service(cfg, n_keys, d, device=device)
    vals = st.store_vals.view(-1, cfg.value_pad)
    flat_keys = st.store_keys.reshape(-1)
    for i in range(0, flat_keys.shape[0], SYNTH_CHUNK):
        k = flat_keys[i:i + SYNTH_CHUNK]
        vals[i:i + SYNTH_CHUNK] = synth_value(k, torch.zeros_like(k),
                                              cfg.value_pad)
    n = hot.shape[0]
    cidx = torch.arange(n, dtype=torch.int32, device=device)
    rs = st.ring
    valid = rs.state.valid.clone()
    valid[:n] = True
    per = lambda x: x.reshape((d, n // d) + x.shape[1:])
    ring = dist.StackedRing(d)
    sl = ring.map(dist.install_into_slice, (
        rs.slice, per(cidx), per(torch.ones(n, dtype=torch.bool,
                                            device=device)),
        per(hot), per(torch.zeros_like(hot)),
        per(torch.full_like(hot, cfg.value_pad)),
        per(synth_value(hot, torch.zeros_like(hot), cfg.value_pad))),
        (0,) * 7, 0)
    return st._replace(ring=rs._replace(
        lookup=lk.install(rs.lookup, cidx, hash128_u32(hot), hot),
        state=rs.state._replace(valid=valid), slice=sl))


def zipf_keys(wl, shape, seed, device):
    """Keys drawn Zipf over the workload's ranks, as the clients draw."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(shape, generator=gen, device=device)
    ranks = torch.searchsorted(wl.cdf, u)
    return wl.perm[torch.clamp(ranks, 0, wl.perm.shape[0] - 1)]


def run_orbit_service(dev):
    """The service at the paper's 10M keys (a 2.56 GB store of 256-B
    values on the card), 8 stacked positions, ``ServiceConfig`` defaults,
    Zipf-0.99 lookups, the 64 hottest keys circulating: cold values byte
    exact, every hot lookup served once with its key's bytes, the first
    steps equal to a CPU run."""
    from repro_torch import kernels as kn
    from repro_torch.configs.orbitcache_paper import WORKLOAD
    from repro_torch.core import distributed as dist
    from repro_torch.interop import to_numpy
    from repro_torch.kvstore.store import synth_value
    from repro_torch.kvstore.workload import Workload
    from repro_torch.serving import orbit_service as svc

    cfg, d = svc.ServiceConfig(), SERVICE_D
    t0 = time.perf_counter()
    wl = Workload(WORKLOAD, device=dev)
    hot = torch.from_numpy(wl.hottest_keys(d * cfg.slice_len)).to(dev)
    st0 = service_setup(cfg, WORKLOAD.num_keys, d, hot, dev)
    keys = zipf_keys(wl, (SERVICE_STEPS, d, cfg.local_batch), 0, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    step = svc.make_service_step(dist.StackedRing(d), cfg)
    ones = torch.ones((d, cfg.local_batch), dtype=torch.bool, device=dev)
    drain = 2 * d             # ceil(queue_size / clones_per_visit) turns

    kn.reset_launch_counts()
    st, outs = st0, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(SERVICE_STEPS):
        st, res, cold, hot_m, serve = step(st, keys[k], ones)
        outs.append((res, cold, hot_m, serve))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    drained = []
    for _ in range(drain):
        st, res, cold, hot_m, serve = step(st, keys[0], ~ones)
        drained.append(serve)
    if any(kn.LAUNCHES.values()):
        raise AssertionError(f"the service launched {kn.LAUNCHES}")
    # device time of a step, from a profile of its first PROFILE_WINDOWS
    busy = busy_per_window(lambda: functools.reduce(
        lambda s, k: step(s, keys[k], ones)[0], range(PROFILE_WINDOWS),
        st0), PROFILE_WINDOWS)

    lookup_kidx = st.ring.lookup.kidx
    n_hot = n_cold = bad_cold = served = bad_hot = 0
    for k, (res, cold, hot_m, serve) in enumerate(outs):
        want = synth_value(keys[k], torch.zeros_like(keys[k]), cfg.value_pad)
        bad_cold += int(((res != want).any(-1) & cold).sum())
        n_hot += int(hot_m.sum())
        n_cold += int(cold.sum())
    for serve in [o[3] for o in outs] + drained:
        rows = serve.served.any(-1)
        served += int(serve.served.sum())
        want = synth_value(serve.kidx, torch.zeros_like(serve.kidx),
                           cfg.value_pad)
        bad_hot += int((((serve.val != want).any(-1)
                         | (serve.kidx != lookup_kidx[None, :])) & rows).sum())
    queued = int(st.ring.reqtab.qlen.sum())
    lookups = SERVICE_STEPS * d * cfg.local_batch

    # the card against the CPU over the first steps
    cpu_step = svc.make_service_step(dist.StackedRing(d), cfg)
    st_c, st_g = clone_tree(st0, torch.device("cpu")), st0
    leaves = 0
    for k in range(SERVICE_CPU_STEPS):
        st_c, *out_c = cpu_step(st_c, keys[k].cpu(), ones.cpu())
        st_g, *out_g = step(st_g, keys[k], ones)
        leaves += compare_trees(to_numpy((st_g.ring, *out_g)),
                                to_numpy((st_c.ring, *out_c)),
                                f"service step {k}")
    phase("orbit_service", positions=d, config=cfg._asdict(),
          num_keys=WORKLOAD.num_keys,
          store_gib=round(st0.store_vals.numel() / 2**30, 3),
          setup_s=round(setup_s, 2), steps=SERVICE_STEPS,
          steps_per_s=round(SERVICE_STEPS / wall, 1),
          lookups_per_s=round(lookups / wall, 1),
          step_rates=rates(SERVICE_STEPS, wall, busy),
          hot_share=n_hot / lookups, cold_share=n_cold / lookups,
          unanswered_share=(lookups - n_hot - n_cold) / lookups,
          hot_served=served, hot_queued=n_hot, queued_after_drain=queued,
          drain_steps=drain, wrong_cold_values=bad_cold,
          wrong_hot_values=bad_hot, card_equals_cpu_steps=SERVICE_CPU_STEPS,
          card_equals_cpu_leaves=leaves, nvidia_smi=nvidia_smi())
    if bad_cold or bad_hot or queued or served != n_hot or not n_cold:
        raise AssertionError("the service's checks failed")


def run_ring_process(dev):
    """A one-rank ``nccl`` ``ProcessRing`` on the card, equal to
    ``StackedRing(1)`` over service steps (one position of 2**16 keys, its
    8 hottest circulating).  D > 1 across processes is checked only with
    gloo on the CPU (tests/test_torch_distributed_ring.py,
    tests/test_torch_orbit_service.py): this machine has one card."""
    import socket

    import torch.distributed as tdist

    from repro_torch.core import distributed as dist
    from repro_torch.kvstore.workload import Workload, WorkloadConfig
    from repro_torch.serving import orbit_service as svc

    cfg = svc.ServiceConfig()
    wl = Workload(WorkloadConfig(num_keys=1 << 16), device=dev)
    hot = torch.from_numpy(wl.hottest_keys(cfg.slice_len)).to(dev)
    st0 = service_setup(cfg, 1 << 16, 1, hot, dev)
    keys = zipf_keys(wl, (RING_PROCESS_STEPS, 1, cfg.local_batch), 1, dev)
    mask = torch.ones((1, cfg.local_batch), dtype=torch.bool, device=dev)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                             rank=0, world_size=1, device_id=dev)
    try:
        tdist.barrier()
        ring = dist.ProcessRing()
        stacked = svc.make_service_step(dist.StackedRing(1), cfg)
        local = svc.make_service_step(ring, cfg)
        st_s, st_p = st0, ring.local(st0, svc.SERVICE_DIMS)
        leaves = 0
        for k in range(RING_PROCESS_STEPS):
            st_s, *out_s = stacked(st_s, keys[k], mask)
            st_p, *out_p = local(st_p, ring.local(keys[k]),
                                 ring.local(mask))
            leaves += same_on_card(
                (st_p, *out_p), (ring.local(st_s, svc.SERVICE_DIMS),
                                 *(ring.local(o) for o in out_s)),
                f"ring_process step {k}")
        backend = tdist.get_backend()
    finally:
        tdist.destroy_process_group()
    phase("ring_process", backend=backend, world_size=1,
          steps=RING_PROCESS_STEPS, equal_leaves=leaves,
          note="D > 1 across processes is verified with gloo on the CPU "
               "only; one card here")


# --------------------------------------------------------------------------
# the structural checks (repro_torch/analysis)
# --------------------------------------------------------------------------
INV_CHUNKS, INV_CHUNK_W = 4, 4      # tests/test_invariants.py's staircase
INV_PERIODS, INV_PERIOD_W = 3, 10   # the control-plane run's periods
INV_SEED = 20


def check_rack(cfg, carry, prev, label, period=False):
    """The post-window invariants of a rack carry (leading point or rack
    axes allowed) against ``prev``, an earlier snapshot or clone: the
    scheme's switch and the servers.  With ``period`` the switch is held
    without ``prev`` (a period resets its popularity counters).  Returns
    the number of racks checked."""
    from repro_torch.analysis import invariants as inv

    before = lambda x: None if prev is None else getattr(prev, x)
    if cfg.scheme == "orbitcache":
        inv.check_switch_invariants(
            carry.policy, None if period else before("policy"), label)
    elif cfg.scheme == "netcache":
        inv.check_netcache_invariants(carry.policy, before("policy"), label)
    inv.check_server_invariants(carry.servers, cfg, before("servers"),
                                label)
    return int(np.prod(carry.servers.qlen.shape[:-1]))


def run_analysis(dev, wl, held):
    """``analysis`` (module docstring, phase 20) on the main path's
    workload ``wl``; ``held`` has the invariant checks of the fleet and
    fabric phases.  Returns the phase's launches by kernel."""
    from repro_torch import kernels as kn
    from repro_torch.analysis.rules import RULES

    t0 = time.perf_counter()
    kn.reset_launch_counts()
    calls = analysis_lint(dev)
    lint_s = time.perf_counter() - t0
    paper = analysis_paper_rack(dev, wl)
    torch.cuda.synchronize()
    launches = dict(kn.LAUNCHES)
    phase("analysis", seconds=round(time.perf_counter() - t0, 3),
          lint=dict(rules=len(RULES), entries=len(calls), findings=0,
                    fixtures_fired=len(RULES), seconds=round(lint_s, 3),
                    calls_per_run=calls),
          **paper, invariants_elsewhere=held, launches=launches)
    return launches


def analysis_lint(dev):
    """All six rules over all six entries on the kernel backend, and every
    rule's seeded violation and clean twin on the card; any finding
    fails.  Returns each entry's expected calls a run."""
    from repro_torch.analysis import fixtures as fx
    from repro_torch.analysis.entry_points import build_entry_points
    from repro_torch.analysis.lint import run_lint
    from repro_torch.analysis.rules import RULES

    entries = build_entry_points(device=dev)
    findings = run_lint(entries)
    if findings:
        raise AssertionError("lint on the card:\n"
                             + "\n".join(f.format() for f in findings))
    for rule, (bad, good, op, fn) in fx.cases(dev).items():
        fired, clean = RULES[rule](bad), RULES[rule](good)
        if not fired or clean or any(
                f.op != op or not f.site.startswith(f"{fn} @ ")
                for f in fired):
            raise AssertionError(
                f"{rule} fixtures on the card: "
                f"{[f.format() for f in fired]} / "
                f"{[f.format() for f in clean]}")
    return {e.name: e.calls for e in entries}


def analysis_paper_rack(dev, wl):
    """The paper rack on the main path's workload ``wl``, graphed: one
    replayed window under the profiler, the staircase (carry in place, no
    recapture, the invariants), then the invariants through period
    updates and on NetCache.  Returns the phase line's fields."""
    from repro_torch.analysis import invariants as inv
    from repro_torch.analysis.profile import KERNEL_SYMBOLS, kernel_summary
    from repro_torch.analysis.rules import leaves
    from repro_torch.configs.orbitcache_paper import RACK, WORKLOAD
    from repro_torch.kvstore.simulator import RackSimulator

    sim = RackSimulator(RACK, wl)
    sim.preload(wl.hottest_keys(RACK.cache_entries))
    ch = sim.chunk

    def window():
        sim.carry, _ = ch(wl.arrays, sim.carry, 1)

    window()
    summ = kernel_summary(window)
    per_window = summ.launches
    seen = {k: summ.kernels[s] for k, s in KERNEL_SYMBOLS.items()}
    want = dict(subround=RACK.subrounds, cms=0, hot_gather=0, orbit_match=0)
    if per_window != want or seen != per_window or summ.htod or summ.dtoh:
        raise AssertionError(f"replayed paper window: LAUNCHES "
                             f"{per_window}, profiler {seen}, HtoD "
                             f"{summ.htod}, DtoH {summ.dtoh}; want {want}")
    rng = np.random.default_rng(INV_SEED)
    captures, ptrs, mem, loads = ch.captures, None, [], []
    prev, n_checks = None, 0
    for i in range(INV_CHUNKS):
        loads.append(float(rng.uniform(0.3, 2.5)) * WORKLOAD.offered_rps)
        sim.set_offered(loads[-1])
        sim.set_write_ratio(float(rng.uniform(0.0, 0.4)))
        sim.run_windows(INV_CHUNK_W)
        check_rack(RACK, sim.carry, prev, f"paper staircase chunk {i}")
        n_checks += 1
        prev = inv.snapshot(sim.carry)
        now = {path: t.data_ptr() for path, t in leaves(sim.carry)}
        if ptrs is not None and now != ptrs:
            raise AssertionError(f"paper staircase chunk {i}: the carry "
                                 f"left the chunk's buffers")
        ptrs = now
        mem.append((torch.cuda.memory_reserved(dev),
                    sum(ch.graph_bytes.values())))
    if ch.captures != captures:
        raise AssertionError(f"sweeping the offered load captured "
                             f"{ch.captures - captures} new graph(s)")
    if mem[-1][0] > mem[1][0] or mem[-1][1] > mem[1][1]:
        raise AssertionError(f"memory grew after chunk 2: {mem}")
    del sim, prev

    # 3. the invariants through period updates (with Fig. 18's hot-set
    # swaps: evictions and CacheIdx inheritance), then NetCache
    cp_rack = dataclasses.replace(RACK, track_popularity=True)
    cp = RackSimulator(cp_rack, wl)
    cp.preload(wl.hottest_keys(cp_rack.cache_entries))
    prev, churn = inv.snapshot(cp.carry), dict(inserted=0, evicted=0)
    for p in range(INV_PERIODS):
        if p:
            wl.hot_in_swap(CP_SWAP)
        cp.run_periods(1, INV_PERIOD_W)
        check_rack(cp_rack, cp.carry, prev, f"control plane period {p}",
                   period=True)
        prev = inv.snapshot(cp.carry)
        churn["inserted"] += int(cp._last_update.n_insert.sum())
        churn["evicted"] += int(cp._last_update.n_evict.sum())
    if not churn["inserted"]:
        raise AssertionError("the control-plane run updated no entry")
    del cp
    nc_rack = dataclasses.replace(RACK, scheme="netcache")
    nc = RackSimulator(nc_rack, wl)
    nc.preload(wl.hottest_keys(nc_rack.netcache_entries))
    prev = inv.snapshot(nc.carry)
    for i in range(INV_CHUNKS - 1):
        nc.set_offered(float(rng.uniform(0.3, 2.0)) * WORKLOAD.offered_rps)
        nc.run_windows(INV_CHUNK_W)
        check_rack(nc_rack, nc.carry, prev, f"netcache chunk {i}")
        prev = inv.snapshot(nc.carry)
    nc_hits = int(nc.carry.policy.hits)
    return dict(
        paper_window=dict(launches=per_window, profiler_kernels=seen,
                          memcpy_htod=summ.htod, memcpy_dtoh=summ.dtoh,
                          device_kernels=summ.device_kernels),
        carry_in_place=dict(chunks=INV_CHUNKS, leaves=len(ptrs),
                            reserved_mib=[round(m / 2**20, 1)
                                          for m, _ in mem],
                            graph_pool_mib=round(mem[-1][1] / 2**20, 1)),
        recapture=dict(captures=ch.captures - captures, offered_rps=loads),
        invariants=dict(staircase_chunks=n_checks,
                        control_plane_periods=INV_PERIODS,
                        control_plane_churn=churn,
                        netcache_chunks=INV_CHUNKS - 1,
                        netcache_hits=nc_hits))

def time_against(dev, other_dir):
    """``--against DIR``: time the four kernels built from
    ``DIR/{subround,cms,hot_gather,orbit_match}.cu`` (other versions with
    the same C interfaces, such as a parent commit's) against the tree's,
    in turns (other, tree, tree, other) on one card, by the same timers as
    the full run: ``subround`` and ``cms`` at the paper rack's shapes,
    ``hot_gather`` at the controller's three call shapes and on the three
    input sets of one control-plane period's ``_merge_scores`` (recorded
    once, with the tree's kernels, from the paper rack after its preload),
    ``orbit_match`` at 352 lanes against 128 entries.  Each version is
    first held against the plain version at the timed inputs."""
    from pathlib import Path

    from repro_torch.kernels import _build
    from repro_torch.kernels.cms import kernel as cms_kernel
    from repro_torch.kernels.cms.ops import update_query
    from repro_torch.kernels.cms.ref import cms_update_query_fast
    from repro_torch.kernels.hot_gather import kernel as hg_kernel
    from repro_torch.kernels.hot_gather.ops import hot_gather
    from repro_torch.kernels.hot_gather.ref import hot_gather_ref
    from repro_torch.kernels.orbit_match import kernel as om_kernel
    from repro_torch.kernels.orbit_match.ops import orbit_match
    from repro_torch.kernels.orbit_match.ref import orbit_match_ref
    from repro_torch.kernels.subround import kernel as sr_kernel
    from repro_torch.kernels.subround.ops import subround
    from repro_torch.kernels.subround.ref import subround_ref

    def same(got, want):
        return all(torch.equal(g, w) for g, w in zip(got, want))

    b, c, s, f, j = PAPER
    sr_args = [torch.from_numpy(np.array(a)).to(dev)
               for a in subround_case(7, b, c, s, f, budget=1000)]
    n, cb, w = CMS_PAPER
    cms_args = cms_case(7, n, cb, w, 1 / 32, dev)
    hg_args = [hg_case(hb + hc, hb, hc, hd, torch.int32, True, dev)
               for hb, hc, hd in HG_CALLS]
    hg_live = []   # recorded once the kernels are built

    def time_hg(d):
        return time_hot_gather(d, yardsticks=False) + [
            dict(shape=dict(b=ids.shape[0], c=hot.shape[0], d=rows.shape[1],
                            live=True), **hg_kernel_times(ids, hot, rows))
            for ids, hot, rows in hg_live]
    om_args = om_case(7, 352, 128, False, "sparse", dev)
    checks = {
        "subround": (sr_kernel, time_kernel, lambda: same(
            subround(*sr_args, s, f, j),
            subround_ref(*sr_args, queue_size=s, max_frags=f,
                         max_serves=j))),
        "cms": (cms_kernel, time_cms, lambda: same(
            update_query(*cms_args, 256),
            cms_update_query_fast(*cms_args, block_b=256))),
        "hot_gather": (hg_kernel, time_hg,
                       lambda: all(same(hot_gather(*a), hot_gather_ref(*a))
                                   for a in hg_args + hg_live)),
        "orbit_match": (om_kernel, time_orbit_match, lambda: same(
            orbit_match(*om_args), orbit_match_ref(*om_args)))}
    # the serial C interfaces (an older source has no batched launch)
    others = {k: _build.KernelLibrary(
        k, Path(other_dir) / f"{k}.cu",
        {n: sig for n, sig in mod.LIB.signatures.items()
         if "batched" not in n})
        for k, (mod, _, _) in checks.items()}
    _build.build_all([mod.LIB for mod, _, _ in checks.values()]
                     + list(others.values()))
    sim, _, period_w = control_plane_rack(dev)
    hg_live += merge_inputs(sim, period_w)
    del sim
    keys = ("device_us", "device_floor_us", "device_timing", "ms",
            "host_issue_ms")
    for k, (mod, timer, equal) in checks.items():
        tree, rows = mod.LIB, []
        try:
            for tag in ("other", "tree", "tree", "other"):
                mod.LIB = others[k] if tag == "other" else tree
                if not equal():
                    raise AssertionError(f"{k} ({tag}) != plain version")
                t = timer(dev)
                rows.append(dict(version=tag, calls=[
                    {x: call[x] for x in ("shape", *keys) if x in call}
                    for call in ([t] if isinstance(t, dict) else t)]))
        finally:
            mod.LIB = tree
        phase("against", kernel=k, other=str(others[k].source), turns=rows)


def compare_trees(a, b, path):
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return sum(compare_trees(x, y, f"{path}.{n}")
                   for n, x, y in zip(a._fields, a, b))
    if isinstance(a, tuple):
        if not isinstance(b, tuple) or len(a) != len(b):
            raise AssertionError(f"replay differs in structure at {path}")
        return sum(compare_trees(x, y, f"{path}[{i}]")
                   for i, (x, y) in enumerate(zip(a, b)))
    if isinstance(a, np.ndarray):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"replay differs at {path}")
        return 1
    return 0


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "smoke run needs a CUDA card")
    against = None
    if sys.argv[1:2] == ["--against"] and len(sys.argv) == 3:
        against = sys.argv[2]
    elif sys.argv[1:]:
        sys.exit("usage: python3 chip_smoke.py [--against DIR]")
    from repro_torch.kernels import _build
    from repro_torch.kernels.cms import kernel as cms_kernel
    from repro_torch.kernels.hot_gather import kernel as hg_kernel
    from repro_torch.kernels.orbit_match import kernel as om_kernel
    from repro_torch.kernels.subround import kernel as sr_kernel

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    phase("device", nvidia_smi=smi, torch_device=name,
          torch=torch.__version__, cuda=torch.version.cuda)
    if against is not None:
        time_against(dev, against)
        print(smi)
        return

    libs = [sr_kernel.LIB, cms_kernel.LIB, hg_kernel.LIB, om_kernel.LIB]
    t0 = time.perf_counter()
    built = _build.build_all(libs, verbose=True)
    for kl in libs:
        kl.library()
    phase("build", seconds=round(time.perf_counter() - t0, 2), kernels={
        kl.name: dict(library=os.path.relpath(path, HERE),
                      ptxas=[ln.strip() for ln in log.splitlines()
                             if "ptxas" in ln])
        for kl, (path, log) in zip(libs, built)})

    n_cases, sr_err = check_kernel(dev)
    sr_time = time_kernel(dev)
    phase("kernel_vs_plain", cases=n_cases, equal=True, max_abs_err=sr_err,
          **sr_time)
    n_cases, cms_err = check_cms(dev)
    cms_time = time_cms(dev)
    phase("cms_vs_plain", cases=n_cases, equal=True, max_abs_err=cms_err,
          **cms_time)
    n_cases, hg_err = check_hot_gather(dev)
    hg_calls = time_hot_gather(dev)
    phase("hot_gather_vs_plain", cases=n_cases, equal=True,
          max_abs_err=hg_err["exact"], f32_max_abs_err=hg_err["f32"],
          f32_tolerance=dict(rtol=F32_TOL, atol=F32_TOL),
          bf16_max_abs_err=hg_err["bf16"],
          bf16_tolerance=dict(rtol=BF16_TOL, atol=BF16_TOL),
          library_f32_device_us=hg_calls[1]["library_f32_two_calls_device_us"],
          calls=hg_calls)

    main_launches, live, wl = run_main_path(dev)
    om = run_orbit_match(dev, live)
    cp_launches = run_control_plane(dev)
    run_schemes(dev)
    held = {}
    batched, fleet_launches = run_fleet(dev, held)
    n_fab, fab_err, fab_times = check_fabric_kernels(dev)
    phase("fabric_batched_vs_plain", cases=n_fab, equal=True,
          max_abs_err=fab_err, nested=dict(zip(("points", "racks"),
                                                FABRIC_NESTED)),
          **fab_times)
    fabric_launches = dict(fabric_paper=run_fabric_paper(dev, held),
                           fabric_locality=run_fabric_locality(dev))
    reg_launches = run_composed_vs_fused(dev)
    run_ring_stacked(dev)
    run_orbit_service(dev)
    run_ring_process(dev)
    analysis_launches = run_analysis(dev, wl, held)

    def launches(k):
        by_path = dict(main_path=(k == "subround") * main_launches,
                       control_plane=cp_launches[k], **fleet_launches[k],
                       **{c: v[k] for c, v in fabric_launches.items()},
                       switch_regression=reg_launches[k],
                       analysis=analysis_launches[k])
        err, us = batched[k]
        return dict(launches=sum(by_path.values()), launches_by_path=by_path,
                    batched_max_abs_err=max(err, fab_err),
                    batched_device_us=us)

    hg = hg_calls[1]          # ids [2048] against hot [2048], the largest

    def device_times(t):
        return {k: t[k] for k in ("device_us", "device_floor_us",
                                  "device_timing", "host_issue_ms")}

    record = [
        dict(name="subround", route="cuda",
             source="src/repro_torch/kernels/subround/kernel.cu",
             replaces="src/repro/kernels/subround/kernel.py:32",
             **launches("subround"), max_abs_err=sr_err, ms=sr_time["ms"],
             **device_times(sr_time),
             plain_ms=sr_time["plain_ms"], bound_ms=sr_time["bound_ms"],
             bound_by=sr_time["bound_by"], library_ms=None),
        dict(name="cms", route="cuda",
             source="src/repro_torch/kernels/cms/kernel.cu",
             replaces="src/repro/kernels/cms/kernel.py:26",
             **launches("cms"), max_abs_err=cms_err, ms=cms_time["ms"],
             **device_times(cms_time),
             plain_ms=cms_time["plain_ms"], bound_ms=cms_time["bound_ms"],
             bound_by=cms_time["bound_by"], library_ms=None),
        dict(name="hot_gather", route="cuda",
             source="src/repro_torch/kernels/hot_gather/kernel.cu",
             replaces="src/repro/kernels/hot_gather/kernel.py:22",
             **launches("hot_gather"),
             max_abs_err=max(hg_err.values()), ms=hg["ms"],
             **device_times(hg),
             plain_ms=hg["plain_ms"], bound_ms=hg["bound_ms"],
             bound_by=hg["bound_by"], library_ms=None),
        dict(name="orbit_match", route="cuda",
             source="src/repro_torch/kernels/orbit_match/kernel.cu",
             replaces="src/repro/kernels/orbit_match/kernel.py:25",
             launches=om["launches"] + analysis_launches["orbit_match"],
             launches_by_path=dict(orbit_match_entry_point=om["launches"],
                                   fleet_staircase=0, fleet_control_plane=0,
                                   fleet_skew=0, fabric_paper=0,
                                   fabric_locality=0,
                                   switch_regression=reg_launches[
                                       "orbit_match"],
                                   analysis=analysis_launches[
                                       "orbit_match"]),
             max_abs_err=om["max_abs_err"], ms=om["ms"],
             **device_times(om),
             plain_ms=om["plain_ms"], bound_ms=om["bound_ms"],
             bound_by=om["bound_by"], library_ms=None),
    ]
    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
