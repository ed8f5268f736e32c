"""The comparison that decides ``correct``: the port's outputs against the
plain reference (:mod:`simbench.reference`), exactly.

The reference runs on the CPU, one thread a process, where the
repository's tests hold the port bit-equal to the JAX package: the
card's answers are held to the simulator's semantics as the CPU computes
them, not to a second run on the card.  Its draws are the inputs: the
reference makes them itself on the run's device with the port's
generator (Philox on the card), from the seed, and replays them on the
CPU (:class:`~simbench.reference.kvstore.client.RecordedDraws`).

Two stretches of the timed path are compared, element for element:

* **start**, every point: the reference builds the cell from the
  configuration and the seed (workload, carry, draws) and preloads it:
  the port's carry after its preload must equal its own.  It then steps
  the set-up's warm-up call and the window's first call: that call's
  per-window metrics, latency histograms and period update, and the
  carry after it, must equal the port's;
* **sample**, one point drawn from the seed: a later call, drawn from
  the seed, followed from the port's own carry before it (its draw state
  and cache size included): the call's metrics, histograms and update,
  and the carry after it.

Each stream of windows (a point's start, the sample) is a job; on the
card's machine the jobs run in worker processes started with ``spawn``,
all ended before :func:`run_jobs` returns.  Every number compared is a
count of differing values, with the limit 0.  Nothing here imports the
port.
"""
from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from .reference import precision
from .reference.kvstore.client import RecordedDraws, TorchDraws
from .reference.kvstore.simulator import RackConfig
from .reference.kvstore.workload import Workload, WorkloadConfig
from .reference.rack import Rack, offered_per_window, preload_windows
from .spec import point_seeds, rack_config, workload_config

LIMITS = {"start_mismatch": 0, "call0_mismatch": 0, "sample_mismatch": 0}


def sample_plan(seed: int, n_points: int) -> dict:
    """Which call the sample follows (one of the window's calls 1-4), and
    of which point: drawn from the seed."""
    rng = np.random.default_rng(seed)
    return {"call": int(rng.integers(1, 5)),
            "point": int(rng.integers(n_points))}


# -- the reference's cell -----------------------------------------------------
@dataclass(frozen=True)
class Spec:
    """A cell as the reference builds it: ``RackConfig`` and
    ``WorkloadConfig`` fields, the traffic, each point's draw seed and
    the keys preloaded."""

    rack: dict
    workload: dict
    traffic: dict
    seeds: tuple
    preload: int

    @property
    def offered(self) -> list[float]:
        pts = self.traffic.get("points")
        return (list(pts["offered_rps"]) if pts
                else [self.workload["offered_rps"]])

    @property
    def period_windows(self) -> int | None:
        p = self.traffic.get("controller_period_s")
        return int(round(p / (self.rack["window_us"] * 1e-6))) if p else None

    @property
    def call_windows(self) -> int:
        return self.period_windows or int(self.traffic.get("chunk_windows",
                                                           256))


def cell_spec(config: dict, traffic: dict, seed: int) -> Spec:
    return Spec(rack_config(config, traffic, seed),
                workload_config(config, traffic, seed), traffic,
                tuple(point_seeds(traffic, seed)),
                int(config["preload_keys"]))


class RefCell:
    """The reference's racks of one cell on the CPU: one per point,
    sharing one workload, as the port's fleet does."""

    def __init__(self, spec: Spec):
        self.spec = spec
        self.device = torch.device("cpu")
        self.cfg = RackConfig(**spec.rack)
        self.wl = Workload(WorkloadConfig(**spec.workload),
                           device=self.device)
        self.perm0 = self.wl._perm_np.copy()

    def set_swaps(self, n: int) -> None:
        """The workload after ``n`` hot-in swaps of the initial one."""
        self.wl._perm_np[:] = self.perm0
        self.wl.perm = torch.from_numpy(self.perm0.copy()).to(self.device)
        for _ in range(n):
            self.wl.hot_in_swap(int(self.spec.traffic["swap_keys"]))

    def rack(self, i: int, draws) -> Rack:
        return Rack(self.cfg, self.wl, self.spec.offered[i],
                    float(self.spec.traffic.get("write_ratio", 0.0)),
                    draws, self.device)

    def call(self, r: Rack):
        """One call of ``r``: ``((traces, hist_switch, hist_server),
        update or None)``."""
        if self.spec.period_windows:
            traces = r.windows(self.spec.period_windows)
            upd = r.period()
        else:
            traces, upd = r.windows(self.spec.call_windows), None
        cs = r.carry.clients
        return (traces, cs.hist_switch.cpu().numpy(),
                cs.hist_server.cpu().numpy()), upd


def swap_due(traffic: dict, i: int) -> bool:
    """Whether the window's call ``i`` follows a hot-in swap."""
    every = traffic.get("swap_every_periods")
    return bool(every) and i % int(every) == 0


# -- jobs ---------------------------------------------------------------------
def record(spec: Spec, i: int, source: TorchDraws,
           windows: int) -> RecordedDraws:
    """``windows`` windows' draws of point ``i`` from ``source``."""
    cfg = RackConfig(**spec.rack)
    return RecordedDraws.record(source, offered_per_window(
        cfg, spec.offered[i]), cfg.client_batch, windows, "cpu")


def start_job(spec: Spec, i: int, device, low=None) -> tuple:
    """Point ``i``'s start: its draws from its seed, made on ``device``
    (the preload's windows, the warm-up call and the first call)."""
    n = preload_windows(spec.rack["scheme"]) + 2 * spec.call_windows
    draws = record(spec, i, TorchDraws(spec.seeds[i], device), n)
    return ("start", i, draws, low)


def sample_job(spec: Spec, i: int, snap: dict, swaps: int, device,
               low=None) -> tuple:
    """The sample of point ``i`` from the port's carry ``snap``, its
    draws made on ``device`` from the port's draw state."""
    source = TorchDraws(0, device)
    source.set_state(snap["_draws"])
    draws = record(spec, i, source, spec.call_windows)
    return ("sample", i, draws, low, snap, swaps)


def replay_start(cell: RefCell, i: int, draws):
    """Stretch *start* of point ``i`` on the reference: the carry after
    the preload, the window's first call (after the set-up's warm-up
    call) and the carry after it."""
    cell.set_swaps(0)
    r = cell.rack(i, draws)
    r.preload(cell.wl.hottest_keys(cell.spec.preload))
    start = carry_of(r)
    cell.call(r)
    cell.set_swaps(int(swap_due(cell.spec.traffic, 0)))
    first = cell.call(r)
    return start, first, carry_of(r)


def replay_sample(cell: RefCell, i: int, draws, snap: dict, swaps: int):
    """Stretch *sample* of point ``i`` on the reference, from the port's
    carry ``snap``: the call and the carry after it."""
    cell.set_swaps(swaps)
    r = cell.rack(i, draws)
    load_carry(r, snap)
    res = cell.call(r)
    return res, carry_of(r)


def run_job(cell: RefCell, job: tuple):
    kind, i, draws, low, *rest = job
    precision.LOW = low
    try:
        if kind == "start":
            return replay_start(cell, i, draws)
        return replay_sample(cell, i, draws, *rest)
    finally:
        precision.LOW = None


_CELL: RefCell | None = None


def _init_worker(spec: Spec) -> None:
    global _CELL
    torch.set_num_threads(1)
    _CELL = RefCell(spec)


def _work(job: tuple):
    return run_job(_CELL, job)


def run_jobs(spec: Spec, jobs: list[tuple], workers: int) -> list:
    """Every job's result, in order: in this process where ``workers`` is
    1, else in up to ``workers`` processes of one thread each."""
    if workers <= 1 or len(jobs) <= 1:
        cell = RefCell(spec)
        return [run_job(cell, job) for job in jobs]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(workers, len(jobs)),
                             mp_context=ctx, initializer=_init_worker,
                             initargs=(spec,)) as pool:
        return list(pool.map(_work, jobs))


# -- carries ------------------------------------------------------------------
def flatten(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """Every tensor leaf of a tree of NamedTuples by its field path (other
    leaves, such as a draw source, left out)."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out: dict[str, torch.Tensor] = {}
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or [str(i) for i in
                                                   range(len(tree))]
        for name, v in zip(names, tree):
            out.update(flatten(v, f"{prefix}.{name}" if prefix else name))
    return out


def _replace(tree, flat: dict, device, prefix: str = ""):
    if isinstance(tree, torch.Tensor):
        return flat[prefix].to(device).clone()
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or [str(i) for i in
                                                   range(len(tree))]
        items = [_replace(v, flat, device, f"{prefix}.{n}" if prefix else n)
                 for n, v in zip(names, tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    return tree


def carry_of(r: Rack) -> dict:
    """A reference rack's carry as a snapshot (see ``System.snapshot``)."""
    return dict({k: v.to("cpu", copy=True)
                 for k, v in flatten(r.carry).items()},
                _draws=r.carry.draws.get_state().clone(),
                _active=int(r.active))


def load_carry(r: Rack, snap: dict) -> None:
    """Put the port's carry ``snap`` into the reference rack ``r``."""
    leaves = set(flatten(r.carry))
    missing = leaves - set(snap)
    if missing:
        raise KeyError(f"the port's carry lacks {sorted(missing)[:4]}")
    r.carry = _replace(r.carry, snap, r.device)
    r.carry.draws.set_state(snap["_draws"])
    r.active.fill_(int(snap["_active"]))
    r.controller.active_size = int(snap["_active"])


# -- comparisons --------------------------------------------------------------
def _values(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.float64)


def differ(got: dict, want: dict, where: str, notes: list) -> int:
    """Values of ``want`` that ``got`` does not hold exactly (NaN equals
    NaN); a missing or reshaped entry counts all its values."""
    n = 0
    for k in sorted(set(got) | set(want)):
        if k not in got or k not in want:
            n += int(_values(got.get(k, want.get(k))).size)
            notes.append(f"{where} {k}: missing on one side")
            continue
        if k == "_draws":
            bad = int(not torch.equal(got[k], want[k]))
        else:
            a, b = _values(got[k]), _values(want[k])
            if a.shape != b.shape:
                bad = int(max(a.size, b.size))
            else:
                bad = int(np.sum(~((a == b) | (np.isnan(a) & np.isnan(b)))))
        if bad:
            notes.append(f"{where} {k}: {bad} values differ")
        n += bad
    return n


def call_differ(got, want, where: str, notes: list) -> int:
    """A call's outputs: ``((traces, hist_switch, hist_server), update)``."""
    (gt, ghs, ghv), gu = got
    (wt, whs, whv), wu = want
    n = differ(gt, wt, f"{where} metrics", notes)
    n += differ({"hist_switch": ghs, "hist_server": ghv},
                {"hist_switch": whs, "hist_server": whv},
                f"{where} histograms", notes)
    if gu is not None or wu is not None:
        n += differ(gu or {}, wu or {}, f"{where} update", notes)
    return n
