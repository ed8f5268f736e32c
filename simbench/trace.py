"""The traced stretch: ``torch.profiler`` over a run of calls, and what
the per-layer readers take from it.

A stretch starts with :data:`LEAD_IN` spin kernels (``torch.cuda._sleep``)
and a synchronize.  The profiler has been seen to drop the first device
records of a session; a spin kernel in the records proves that the drop,
if any, ended before the stretch (the technique of the port's
``analysis/profile.py``).  The stretch itself is one host span,
``simbench.stretch``: its length is the traced window, and the union of
the device's intervals inside it is the busy time.  Each call, swap and
snapshot inside it has a span of its own, so an idle gap can be named
by what the host was doing.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

LEAD_IN = 1024
SPIN = "spin_kernel"
STRETCH = "simbench.stretch"
SPAN_PREFIX = "simbench."
SHORT_GAP_US = 20.0      # gaps shorter than this are lumped together
TOP = 10


def span(name: str):
    """A host span the trace can name a gap by."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


@dataclass
class Stretch:
    """What one traced stretch recorded."""

    windows: int = 0                  # simulator windows stepped in it
    periods: int = 0                  # period boundaries in it
    window_s: float = 0.0             # the stretch span's length
    busy_s: float = 0.0               # union of the device's intervals
    lead_in_seen: int = 0
    ops: int = 0                      # device kernels, no memcpy / memset
    by_name: dict = field(default_factory=dict)   # name -> (count, s)
    idle_by_label: dict = field(default_factory=dict)
    reduce_s: float = 0.0             # host seconds the reduction took

    def kernel(self, symbol: str) -> tuple[int, float]:
        """Launches and device seconds of the kernels named ``symbol``."""
        n = s = 0
        for name, (c, t) in self.by_name.items():
            if symbol in name:
                n, s = n + c, s + t
        return n, s

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
        gaps = sorted(self.idle_by_label.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n[:160], s] for n, (_, s) in ops],
                "idle_gaps": [[n[:160], s] for n, s in gaps[:TOP]]}


class Profiler:
    """``torch.profiler`` around a stretch of calls on the card.  The
    stretch's records are read raw from the profiler's result: building
    the profiler's Python events for some 300,000 device records takes
    half a minute."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.stretch = Stretch()
        self._span = None

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof.start()
        for _ in range(LEAD_IN):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        self._span = span("stretch")
        self._span.__enter__()

    def stop(self) -> Stretch:
        torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        t0 = time.perf_counter()
        result = torch.autograd._disable_profiler()
        reduce_events([record(e) for e in result.events()], self.stretch)
        self.stretch.reduce_s = time.perf_counter() - t0
        return self.stretch


def record(e) -> tuple[str, str, int, int]:
    """``(kind, name, start ns, end ns)`` of a raw profiler event; kind is
    ``device`` (a kernel, copy or set on the card), ``host``, or ``mark``
    (the device-side copy of a host span)."""
    on_card = e.device_type() == torch.autograd.DeviceType.CUDA
    mark = e.is_user_annotation() or e.name().startswith(SPAN_PREFIX)
    kind = ("mark" if mark and on_card else "device" if on_card else "host")
    return kind, e.name(), e.start_ns(), e.end_ns()


def reduce_events(events, st: Stretch) -> None:
    """Fill ``st`` from the stretch's records (:func:`record`): the
    stretch span, the device intervals inside it, their union, and the
    idle gaps named by the innermost host span over each."""
    dev, cpu = [], []
    window = None
    for kind, name, s, e in events:
        if kind == "device":
            if SPIN in name:
                st.lead_in_seen += 1
            else:
                dev.append((s, e, name))
        elif kind == "host":
            if name == STRETCH:
                window = (s, e)
            cpu.append((s, e, name))
    if not st.lead_in_seen:
        raise AssertionError(f"the profiler dropped all {LEAD_IN} lead-in "
                             f"kernels: the stretch's records may be "
                             f"incomplete")
    if window is None:
        raise AssertionError("the profiler recorded no stretch span")
    w0, w1 = window
    dev = [d for d in dev if d[0] >= w0 and d[1] <= w1]
    st.window_s = (w1 - w0) * 1e-9
    by_name: dict = defaultdict(lambda: [0, 0.0])
    for s, e, name in dev:
        rec = by_name[name]
        rec[0] += 1
        rec[1] += (e - s) * 1e-9
        low = name.lower()
        if "memcpy" not in low and "memset" not in low:
            st.ops += 1
    st.by_name = {k: (c, s) for k, (c, s) in by_name.items()}

    # union of the device's intervals, and the gaps between them
    dev.sort()
    busy, gaps, cur = 0.0, [], None
    edge = w0
    for s, e, _ in dev:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            if s > edge:
                gaps.append((edge, s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
        edge = max(edge, e)
    if cur is not None:
        busy += cur[1] - cur[0]
    if w1 > edge:
        gaps.append((edge, w1))
    st.busy_s = busy * 1e-9
    st.idle_by_label = _label_gaps(gaps, cpu)


def _label_gaps(gaps, cpu) -> dict:
    """Idle seconds by what the host was doing: the benchmark's innermost
    span over each gap's middle, and the innermost host op there."""
    idle: dict = defaultdict(float)
    if not gaps:
        return {}
    starts = np.array([c[0] for c in cpu], np.float64)
    ends = np.array([c[1] for c in cpu], np.float64)
    durs = ends - starts
    names = [c[2] for c in cpu]
    whole = np.array([n == STRETCH for n in names])
    ours = np.array([n.startswith(SPAN_PREFIX) for n in names]) & ~whole
    for g0, g1 in gaps:
        length = g1 - g0
        if length < SHORT_GAP_US * 1e3:
            idle[f"between device ops (gaps under {SHORT_GAP_US:g} us)"] += \
                length * 1e-9
            continue
        mid = 0.5 * (g0 + g1)
        over = (starts <= mid) & (ends >= mid)
        label = "host outside any span"
        mine = over & ours
        if mine.any():
            i = int(np.flatnonzero(mine)[np.argmin(durs[mine])])
            label = names[i]
        inner = over & ~ours & ~whole
        if inner.any():
            i = int(np.flatnonzero(inner)[np.argmin(durs[inner])])
            label += " > " + names[i]
        idle[label] += length * 1e-9
    return dict(idle)
