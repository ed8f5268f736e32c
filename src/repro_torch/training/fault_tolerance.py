"""Fault tolerance for long runs (port of
``repro.training.fault_tolerance``; pure Python over the port's
checkpoints).

1. **Checkpoint/restart** -- ``TrainSupervisor`` wraps the train loop:
   periodic atomic checkpoints (``checkpoint.py``), resume from the latest
   committed step, deterministic data (``data.py``) keyed by step so the
   token stream replays exactly.

2. **Straggler detection** -- per-step wall-times feed an EWMA; a step
   slower than ``straggler_factor`` x the EWMA is logged and counted.

3. **Elastic rescale** -- ``plan_rescale`` recomputes (data-axis size,
   per-host batch, microbatching) for a new device count.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from . import checkpoint as ckpt


@dataclass
class StragglerStats:
    ewma_s: float = 0.0
    count: int = 0
    slowest_s: float = 0.0

    def update(self, dt: float, factor: float = 2.0) -> bool:
        if self.ewma_s == 0.0:
            self.ewma_s = dt
            return False
        is_straggler = dt > factor * self.ewma_s
        self.ewma_s = 0.9 * self.ewma_s + 0.1 * dt
        if is_straggler:
            self.count += 1
            self.slowest_s = max(self.slowest_s, dt)
        return is_straggler


@dataclass(frozen=True)
class RescalePlan:
    data_parallel: int
    per_shard_batch: int
    microbatches: int


def plan_rescale(global_batch: int, new_num_hosts: int,
                 max_per_shard: int) -> RescalePlan:
    """Recompute the batch split after adding/removing hosts, preserving
    the global batch (optimizer-equivalent resume)."""
    dp = new_num_hosts
    while global_batch % dp:
        dp -= 1
    per = global_batch // dp
    micro = 1
    while per // micro > max_per_shard:
        micro *= 2
    return RescalePlan(data_parallel=dp, per_shard_batch=per,
                       microbatches=micro)


@dataclass
class TrainSupervisor:
    """Checkpoint/restart wrapper around a step function."""

    ckpt_dir: str
    ckpt_every: int = 100
    straggler_factor: float = 2.0
    stragglers: StragglerStats = field(default_factory=StragglerStats)

    def resume_step(self) -> int:
        last = ckpt.latest(self.ckpt_dir)
        return 0 if last is None else last + 1

    def restore(self, like: Any, device=None):
        last = ckpt.latest(self.ckpt_dir)
        if last is None:
            return None, 0
        return ckpt.restore(self.ckpt_dir, last, like, device), last + 1

    def run(
        self,
        state: Any,
        step_fn: Callable[[Any, int], Any],
        num_steps: int,
        start_step: int = 0,
        on_step: Optional[Callable[[int, float], None]] = None,
    ) -> Any:
        for step in range(start_step, num_steps):
            t0 = time.time()
            state = step_fn(state, step)
            dt = time.time() - t0
            self.stragglers.update(dt, self.straggler_factor)
            if on_step:
                on_step(step, dt)
            if (step + 1) % self.ckpt_every == 0 or step + 1 == num_steps:
                ckpt.save(self.ckpt_dir, step, state)
        return state
