"""Summaries of recorded traces and device profiles (counterpart of
``repro.analysis.hlo``).

* :func:`op_summary` counts the ops of an ``op_trace`` recording, the
  counterpart of ``opcode_summary``;
* :func:`kernel_summary`, on the card only, runs a callable (one replayed
  graphed window, say) under ``torch.profiler`` and returns the CUDA
  kernels it saw by name with their counts, the run's ``LAUNCHES`` and
  the number of host-to-device and device-to-host copies.  The ``kernel-launches`` rule holds
  each hand-written kernel's count (:data:`KERNEL_SYMBOLS`) against
  ``kernels.LAUNCHES`` with it, and a replayed chunk to no copy.

``donation_intent``, ``donation_honored`` and ``scatter_instructions``
read XLA's compiled module; the port has no such module, and what they
checked is the ``carry-in-place`` and ``no-scatter`` rules' work.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

import torch

# LAUNCHES key -> the CUDA symbol of its hand-written kernel
KERNEL_SYMBOLS = {"subround": "subround_kernel", "cms": "cms_kernel",
                  "hot_gather": "hot_gather_kernel",
                  "orbit_match": "orbit_match_kernel"}


@dataclass
class OpSummary:
    counts: dict = field(default_factory=dict)   # op -> records
    total: int = 0

    def top(self, n: int = 10) -> list[tuple[str, int]]:
        return sorted(self.counts.items(), key=lambda kv: -kv[1])[:n]


def op_summary(records) -> OpSummary:
    """Records per op of an ``op_trace`` recording."""
    counts = Counter(r.op for r in records)
    return OpSummary(counts=dict(counts), total=sum(counts.values()))


@dataclass
class KernelSummary:
    kernels: dict          # symbol of a hand-written kernel -> launches
    launches: dict         # ``kernels.LAUNCHES`` of the recorded run
    device_kernels: int    # the run's device kernels the profiler saw
    htod: int              # host-to-device copies
    dtoh: int              # device-to-host copies


LEAD_IN = 1024   # spin kernels a session launches before the recorded run


def kernel_summary(run) -> KernelSummary:
    """``run()`` under ``torch.profiler`` on the card, after
    :data:`LEAD_IN` spin kernels (``torch.cuda._sleep``) in the same
    session, each part ending in a synchronize.

    A session can drop its first device records: on the H100, after a few
    hundred seconds of earlier sessions in a process, the first 21 of every
    session, a lone kernel's included, whatever the session waited.  A
    spin kernel seen proves that the dropped prefix ended before the run;
    if none is seen this raises, as it does without a card."""
    from repro_torch import kernels as kn

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_summary profiles the CUDA card; "
                           "torch.cuda.is_available() is False")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(LEAD_IN):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        before = dict(kn.LAUNCHES)
        run()
        torch.cuda.synchronize()
    launches = {k: kn.LAUNCHES[k] - before[k] for k in before}
    names = {e.key: e.count for e in prof.key_averages()
             if getattr(e, "device_type", None)
             == torch.autograd.DeviceType.CUDA}
    lead = sum(n for k, n in names.items() if "spin_kernel" in k)
    if not lead:
        raise AssertionError(f"the profiler dropped all {LEAD_IN} lead-in "
                             f"kernels: the run's records may be "
                             f"incomplete")
    kernels = {sym: sum(n for k, n in names.items() if sym in k)
               for sym in KERNEL_SYMBOLS.values()}
    copies = lambda kind: sum(n for k, n in names.items()
                              if "memcpy" in k.lower() and kind in k)
    return KernelSummary(
        kernels=kernels, launches=launches,
        device_kernels=sum(n for k, n in names.items()
                           if "memcpy" not in k.lower()
                           and "memset" not in k.lower()) - lead,
        htod=copies("HtoD"), dtoh=copies("DtoH"))
