"""The production entry points the linter covers (port of
``repro.analysis.entry_points``).

Each :class:`EntryPoint` builds a *tiny but production-shaped* instance of
one surface on the ``device`` it is given (the CUDA card unless the
caller asks for the CPU), with the reference's names and geometry (C = 8,
2 servers, 16 lanes, fetch 8, ``value_pad`` 32, ``server_queue`` 8, 2
subrounds, ``max_serves`` 4, queue 4; 256 keys; controller 8 / 8 /
``k_report`` 4; fabric: 2 racks, spine C 8, 8 spine and 8 forward lanes).
:meth:`EntryPoint.harness` makes a :class:`Harness`: what a rule drives.

The port's chunks are eager or graphed, not traced, so an entry's
expected kernel count is the dispatcher calls (``kernels.CALLS``) of ONE
run of its harness, derived from the code (R = 2 subrounds):

* ``subround_pipeline``: one call, 1 ``subround``;
* ``window_pipeline``: R = 2 ``subround``;
* ``compiled_controller_chunk`` (a chunk of 1 period of 2 windows,
  tracking on): 2 windows x R = 4 ``subround``, 1 ``cms`` a window = 2,
  3 ``hot_gather`` a period (``controller._merge_scores``);
* ``fleet.window_step`` (P = 2, a chunk of 1 window): R = 2 ``subround``
  whatever P (one batched call a call site);
* ``fabric_window_step`` (a chunk of 1 window, no tracking): R rack + R
  spine = 4 ``subround``, 0 ``cms``;
* ``fabric_controller_chunk`` (1 period of 2 windows, tracking): 2 x (R +
  R) = 8 ``subround``, 2 ``cms``, 3 rack + 3 spine = 6 ``hot_gather``.

On the ``cuda`` backend every call launches once (``kernels.LAUNCHES``
equals ``CALLS``); on ``ref`` nothing launches.
"""
from __future__ import annotations

import functools
import inspect
import pathlib
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

PAD = 32  # tiny value payload for lint builds
R = 2     # subrounds of every lint rack
_SRC = pathlib.Path(__file__).resolve().parents[2]


@dataclass
class Harness:
    """What the rules drive on one built entry.

    * ``run()``: one run of the entry (a chunk, or one call);
    * ``bodies``: ``(object, attribute, name)`` of each body method a run
      calls (``op_trace.trace`` marks them); none: the run is one body;
    * ``step(carry) -> carry'`` and ``carry()``: the pure window (or call)
      and a fresh input carry for it (``counter-saturation``);
    * ``chunk`` and ``state()``: the chunk object and the carry it holds
      after a run (``carry-in-place``, ``recapture-guard``);
    * ``sweep(value)``: sets the documented axis between chunks;
    * ``replayed``: a run replays CUDA graphs (copies nothing between host
      and device).
    """

    run: Callable[[], Any]
    bodies: tuple = ()
    step: Callable | None = None
    carry: Callable | None = None
    chunk: Any = None
    state: Callable | None = None
    sweep: Callable | None = None
    replayed: bool = False


@dataclass
class EntryPoint:
    name: str
    build: Callable[..., Harness]   # build(device, graphs) -> Harness
    calls: dict                     # dispatcher calls of one run, by kernel
    device: torch.device = torch.device("cpu")
    axis: str | None = None         # the documented swept axis
    sweep_values: tuple = ()
    body_fn: Callable | None = None  # the function a finding's site names
    # harnesses by ``graphs``, and the op trace (``rules.op_records``)
    _built: dict = field(default_factory=dict, repr=False)

    def harness(self, graphs: bool | None = None) -> Harness:
        """The entry built once per ``graphs`` (None: the device's
        default, CUDA graphs on the card)."""
        if graphs not in self._built:
            self._built[graphs] = self.build(self.device, graphs)
        return self._built[graphs]

    @property
    def site(self) -> str:
        """``name @ repro_torch/...:line`` of the entry's body function."""
        fn = self.body_fn
        if fn is None:
            return ""
        path = pathlib.Path(inspect.getsourcefile(fn)).resolve()
        try:
            path = path.relative_to(_SRC)
        except ValueError:
            pass
        return (f"{fn.__qualname__} @ {path}:"
                f"{inspect.getsourcelines(fn)[1]}")


def clone_tree(x):
    """A copy of every tensor leaf (other leaves shared)."""
    from repro_torch.kvstore.simulator import tree_map
    return tree_map(torch.clone, x)


# ---------------------------------------------------------------------------
# tiny shared geometry
# ---------------------------------------------------------------------------
def _rack_cfg(**kw):
    from repro_torch.kvstore.simulator import RackConfig
    base = dict(scheme="orbitcache", cache_entries=8, num_servers=2,
                client_batch=16, fetch_lanes=8, value_pad=PAD,
                server_queue=8, subrounds=R, max_serves=4, queue_size=4)
    base.update(kw)
    return RackConfig(**base)


@functools.lru_cache(maxsize=None)
def _workload(device: torch.device):
    from repro_torch.kvstore.workload import Workload, WorkloadConfig
    return Workload(WorkloadConfig(num_keys=256, offered_rps=1e5),
                    device=device)


def _ctrl_cfg():
    from repro_torch.core.controller import ControllerConfig
    return ControllerConfig(active_size=8, max_size=8, k_report=4)


def _fabric_cfg():
    from repro_torch.kvstore.fabric_sim import FabricConfig
    return FabricConfig(n_racks=2, spine_scheme="orbitcache",
                        spine_cache_entries=8, spine_lanes=8, fwd_lanes=8)


def _chunk_harness(sim, run, graphs_on, sweep=None, period=False):
    """A harness over a simulator's chunk: ``run`` one chunk, its bodies
    recorded, the window step pure."""
    ch = sim.chunk
    wl = sim.wl.arrays if not hasattr(sim, "_wl") else sim._wl
    bodies = ((ch, "window_body", "window"),)
    if period:
        bodies += ((ch, "period_body", "period"),)
    return Harness(
        run=run, bodies=bodies,
        step=lambda c: ch.step(wl, c)[0],
        carry=lambda: clone_tree(sim.carry),
        chunk=ch, state=lambda: sim.carry,
        sweep=sweep if graphs_on else None, replayed=graphs_on)


# ---------------------------------------------------------------------------
# the six entries
# ---------------------------------------------------------------------------
def _subround_pipeline(device) -> EntryPoint:
    from repro_torch.core import pipeline

    def build(dev, graphs):
        from repro_torch.core.types import empty_batch, init_switch_state
        sw = init_switch_state(8, queue_size=4, value_pad=PAD, device=dev)
        carry0, _ = pipeline.strip_val(sw)
        pk = empty_batch(16, value_pad=PAD, device=dev)
        budget = torch.tensor(10, dtype=torch.int32, device=dev)
        step = lambda c: pipeline.subround_pipeline(c, pk, budget, 4)[0]
        return Harness(run=lambda: step(carry0), step=step,
                       carry=lambda: clone_tree(carry0))

    return EntryPoint("subround_pipeline", build, dict(subround=1),
                      device, body_fn=pipeline.subround_pipeline)


def _window_pipeline(device) -> EntryPoint:
    from repro_torch.core import pipeline

    def build(dev, graphs):
        from repro_torch.core.types import (
            PacketBatch, empty_batch, init_switch_state,
        )
        sw0 = init_switch_state(8, queue_size=4, value_pad=PAD, device=dev)
        pk = empty_batch(16, value_pad=PAD, device=dev)
        sub = PacketBatch(*(torch.stack([a] * R) for a in pk))

        def step(sw):
            return pipeline.window_pipeline(
                sw, sub, recirc_gbps=100.0, window_us=100.0, subrounds=R,
                max_serves=4, key_size=16)[0]

        return Harness(run=lambda: step(sw0), step=step,
                       carry=lambda: clone_tree(sw0))

    return EntryPoint("window_pipeline", build, dict(subround=R), device,
                      body_fn=pipeline.window_pipeline)


def _controller_chunk(device) -> EntryPoint:
    from repro_torch.kvstore import simulator as sim_mod

    def build(dev, graphs):
        cfg = _rack_cfg(track_popularity=True)
        sim = sim_mod.RackSimulator(cfg, _workload(dev), device=dev,
                                    graphs=graphs)
        ctrl = _ctrl_cfg()

        def run():
            sim.carry, _, _, _ = sim.chunk.controller_chunk(
                sim.wl.arrays, sim.carry, sim.controller.active_size, ctrl,
                1, 2)

        def sweep(active):
            sim.controller.active_size = active

        return _chunk_harness(sim, run, sim.chunk.graphs, sweep, period=True)

    return EntryPoint("compiled_controller_chunk", build,
                      dict(subround=2 * R, cms=2, hot_gather=3), device,
                      axis="active_size", sweep_values=(5, 8),
                      body_fn=sim_mod.window_step)


def _fleet_window_step(device) -> EntryPoint:
    from repro_torch.kvstore import fleet as fl

    def build(dev, graphs):
        f = fl.BatchedRackSimulator(_rack_cfg(), _workload(dev), seeds=(0, 1),
                                    device=dev, graphs=graphs)

        def run():
            f.carry, _ = f.chunk(f._wl, f.carry, 1)

        return _chunk_harness(f, run, f.chunk.graphs,
                              lambda rps: f.set_offered(rps))

    return EntryPoint("fleet.window_step", build, dict(subround=R), device,
                      axis="offered_rps", sweep_values=(4e4, 9e4),
                      body_fn=fl.fleet_window_step)


def _fabric(dev, graphs, **kw):
    from repro_torch.kvstore import fabric_sim as fs
    return fs.FabricSimulator(_rack_cfg(**kw), _fabric_cfg(), _workload(dev),
                              device=dev, graphs=graphs)


def _fabric_window_step(device) -> EntryPoint:
    from repro_torch.kvstore import fabric_sim as fs

    def build(dev, graphs):
        sim = _fabric(dev, graphs)

        def run():
            sim.carry, _ = sim.chunk(sim.wl.arrays, sim.carry, 1)

        return _chunk_harness(sim, run, sim.chunk.graphs,
                              lambda f: sim.set_local_frac(f))

    return EntryPoint("fabric_window_step", build, dict(subround=2 * R, cms=0),
                      device, axis="local_frac", sweep_values=(0.5, 0.9),
                      body_fn=fs.fabric_window_step)


def _fabric_controller_chunk(device) -> EntryPoint:
    from repro_torch.kvstore import fabric_sim as fs

    def build(dev, graphs):
        sim = _fabric(dev, graphs, track_popularity=True)
        ctrl = _ctrl_cfg()
        n_racks = sim.fcfg.n_racks

        def run():
            sim.carry, _, _, _ = sim.chunk.controller_chunk(
                sim.wl.arrays, sim.carry,
                ([ctrl.active_size] * n_racks, ctrl.active_size),
                (ctrl, ctrl), 1, 2)

        return _chunk_harness(sim, run, sim.chunk.graphs,
                              lambda f: sim.set_local_frac(f), period=True)

    return EntryPoint("fabric_controller_chunk", build,
                      dict(subround=2 * 2 * R, cms=2, hot_gather=6), device,
                      axis="local_frac", sweep_values=(0.5, 0.9),
                      body_fn=fs.fabric_window_step)


_ENTRY_FNS = (
    _subround_pipeline,
    _window_pipeline,
    _controller_chunk,
    _fleet_window_step,
    _fabric_window_step,
    _fabric_controller_chunk,
)


def build_entry_points(names=None, device=None) -> list[EntryPoint]:
    """All six production entry points on ``device`` (the CUDA card unless
    given), optionally filtered by name."""
    from repro_torch.core.types import resolve_device

    dev = resolve_device(device)
    eps = [b(dev) for b in _ENTRY_FNS]
    if names:
        wanted = set(names)
        unknown = wanted - {e.name for e in eps}
        if unknown:
            raise ValueError(f"unknown entry points: {sorted(unknown)}")
        eps = [e for e in eps if e.name in wanted]
    return eps
