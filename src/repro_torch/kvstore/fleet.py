"""Batched multi-rack sweeps (port of ``repro.kvstore.fleet``'s
``BatchedRackSimulator``): N identically shaped racks, one per sweep
point, advance in lockstep.

The paper's evaluation is sweeps: offered load, Zipf skew, seeds.  The
reference ``vmap``s its one ``window_step`` over a leading point axis
inside a single jitted scan; the port runs its one
:func:`~repro_torch.kvstore.simulator.window_step` under
``torch.func.vmap`` over the same axis (:func:`fleet_window_step`), and
with a controller period the boundary too (:func:`fleet_controller_apply`).
Inside, the three kernels are custom ops whose batching rule launches
ONCE for all points (``repro_torch.kernels``: ``subround`` one block per
point, ``cms`` the P x 32 sketches, ``hot_gather`` grid z = P), the
counterpart of the reference's one ``pallas_call`` for all points.  On the
card a chunk is a CUDA graph of one fleet window (and one fleet period
boundary), replayed: :class:`FleetChunk`, the batched form of
:class:`~repro_torch.kvstore.simulator.CompiledChunk`.

Random draws stay per point and outside vmap: each point keeps its own
source (a ``TorchDraws(seed_i)`` or a ``ReplayDraws`` row), the fleet
window draws every point's ``(n, u, w)`` first and hands them to the
vmapped window through ``client.GivenDraws``.  So point ``i`` equals a
serial ``RackSimulator`` with the same source, leaf for leaf.

Axes that change data (offered load, write ratio, Zipf CDF, value sizes,
seed) batch; axes that change shapes or control flow (scheme,
cache_entries, num_servers, ...) are static: one fleet per RackConfig.
Workload leaves are stacked only where the points differ
(:meth:`BatchedRackSimulator._wl_and_axes`).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.baselines import netcache_install
from repro_torch.core.controller import CacheController, ControllerConfig
from repro_torch.core.types import resolve_device
from repro_torch.interop import to_numpy

from . import client as cl
from .simulator import (
    CompiledChunk, RackConfig, SimCarry, SimResult, WindowMetrics,
    build_fetch_batch, chunk_graphs, chunked_run, controller_window_apply,
    counting, init_carry, make_client_config, make_server_config,
    period_windows, tree_stack, tree_take, window_step, write_path_of,
)
from .workload import Workload, WorkloadArrays

I32 = torch.int32


class FleetDraws:
    """The points' draw sources, one each, behind the interface a chunk
    uses (``reserve``, ``generators``, ``get_state`` / ``set_state``).
    :meth:`draw_all` takes one window's draws of every point, stacked."""

    def __init__(self, sources):
        self.sources = list(sources)

    def draw_all(self, offered: torch.Tensor, b: int):
        """``(n [P], u [P, b], w [P, b])``, point ``i`` drawn from its own
        source at ``offered[i]``."""
        ds = [s.draw(offered[i], b) for i, s in enumerate(self.sources)]
        return tuple(torch.stack(x) for x in zip(*ds))

    def reserve(self, n: int) -> None:
        for s in self.sources:
            s.reserve(n)

    def generators(self) -> list[torch.Generator]:
        return [g for s in self.sources for g in s.generators()]

    def get_state(self) -> list:
        return [s.get_state() for s in self.sources]

    def set_state(self, state: list) -> None:
        for s, st in zip(self.sources, state, strict=True):
            s.set_state(st)


def fleet_window_step(cfg: RackConfig, server_cfg, client_cfg, key_size: int,
                      wl: WorkloadArrays, wl_dims: WorkloadArrays,
                      carry: SimCarry, donate: bool = False,
                      counts: torch.Tensor | None = None,
                      ) -> tuple[SimCarry, WindowMetrics]:
    """One window of every point: the draws per point, then ``window_step``
    vmapped over the point axis (``wl_dims``: 0 for a stacked workload
    leaf, None for a shared one; ``donate`` and ``counts`` as
    ``window_step``'s).  The carry's ``draws`` is a :class:`FleetDraws`;
    every other leaf, the metrics and ``counts`` are ``[P, ...]``."""
    n, u, w = carry.draws.draw_all(carry.offered, client_cfg.batch)

    def one(wl_i, carry_i, n_i, u_i, w_i, counts_i):
        new, m = window_step(
            cfg, server_cfg, client_cfg, key_size, wl_i,
            carry_i._replace(draws=cl.GivenDraws(n_i, u_i, w_i)), donate,
            counts_i)
        return new._replace(draws=()), m

    new, m = torch.func.vmap(
        one, in_dims=(wl_dims, 0, 0, 0, 0, None if counts is None else 0))(
        wl, carry._replace(draws=()), n, u, w, counts)
    return new._replace(draws=carry.draws), m


def fleet_controller_apply(cfg: RackConfig, ctrl_cfg: ControllerConfig,
                           wl: WorkloadArrays, wl_dims: WorkloadArrays,
                           carry: SimCarry, active_size: torch.Tensor):
    """One period boundary of every point (``controller_window_apply``
    vmapped), ``active_size`` int32[P]: ``(carry', active', TracedUpdate
    [P, ...])``."""
    def one(wl_i, carry_i, act_i):
        return controller_window_apply(cfg, ctrl_cfg, wl_i, carry_i,
                                       act_i)[:3]

    new, act, upd = torch.func.vmap(one, in_dims=(wl_dims, 0, 0))(
        wl, carry._replace(draws=()), active_size)
    return new._replace(draws=carry.draws), act, upd


class FleetChunk(CompiledChunk):
    """A chunk of fleet windows (and periods): :class:`CompiledChunk`'s
    buffers, capture and replay, with its window and period bodies vmapped
    over the points.  Its carry leaves and metric rows carry the point
    axis (metrics ``[n, P, ...]``), ``active`` is int32[P], and a window
    graph registers every point's generator.  The stacked-or-shared axes
    of the workload key its graphs too."""

    def __init__(self, cfg, server_cfg, client_cfg, key_size: int, device,
                 graphs: bool, n_points: int):
        super().__init__(cfg, server_cfg, client_cfg, key_size, device,
                         graphs)
        self.active = torch.zeros(n_points, dtype=I32, device=device)
        if self.sink is not None:
            self.sink = torch.zeros(n_points, 3, dtype=I32, device=device)
        self.wl_dims: WorkloadArrays | None = None

    def set_wl_dims(self, dims: WorkloadArrays) -> None:
        """Which workload leaves are stacked; a change of them re-makes the
        workload buffers and recaptures."""
        if dims != self.wl_dims:
            self.wl_dims, self.wl = dims, None
            self._graphs.clear()

    def step(self, wl, carry, donate=False):
        return fleet_window_step(self.cfg, self.server_cfg, self.client_cfg,
                                 self.key_size, wl, self.wl_dims, carry,
                                 donate, self.sink)

    def apply(self, wl, carry, active):
        return fleet_controller_apply(self.cfg, self.ctrl_cfg, wl,
                                      self.wl_dims, carry, active)

    def set_active(self, active_size) -> None:
        for i, v in enumerate(active_size):
            self.active[i].fill_(int(v))


def _points_major(tree):
    """A chunk's ``[n, P, ...]`` rows (numpy, a tree) as the reference's
    ``[P, n, ...]``."""
    if isinstance(tree, np.ndarray):
        return np.ascontiguousarray(np.moveaxis(tree, 0, 1))
    return type(tree)(*(_points_major(v) for v in tree))


class BatchedRackSimulator:
    """N identically shaped racks advancing in lockstep (one per sweep
    point).

    Args (the reference's, plus the port's ``device``, ``draws`` and
    ``graphs``):
      cfg: the shared static rack configuration.
      workloads: one Workload per point, or a single Workload shared by all.
      offered_rps / write_ratios: per-point overrides (a scalar broadcasts);
        default to each point's workload config.
      seeds: per-point RNG seeds (default ``cfg.seed + point index``).
      n_points: batch width when every other argument is scalar or shared.
      device: the CUDA card unless given (``"cpu"`` for the tests).
      draws: one draw source per point (default ``TorchDraws(seeds[i])``).
      graphs: CUDA graphs for the chunks (default: on a CUDA device).
    """

    def __init__(self, cfg: RackConfig,
                 workloads: Workload | Sequence[Workload],
                 offered_rps: float | Sequence[float] | None = None,
                 write_ratios: float | Sequence[float] | None = None,
                 seeds: Sequence[int] | None = None,
                 n_points: int | None = None, device=None, draws=None,
                 graphs: bool | None = None):
        if isinstance(workloads, Workload):
            workloads = [workloads]
        workloads = list(workloads)

        def aslist(x):
            if x is None or np.isscalar(x):
                return None if x is None else [float(x)]
            return [float(v) for v in x]

        offered = aslist(offered_rps)
        ratios = aslist(write_ratios)
        n = max(len(workloads), len(offered) if offered else 1,
                len(ratios) if ratios else 1,
                len(seeds) if seeds is not None else 1,
                len(draws) if draws is not None else 1, n_points or 1)

        def bcast(xs, what):
            if len(xs) == 1:
                return xs * n
            if len(xs) != n:
                raise ValueError(f"{what}: got {len(xs)} entries for {n} "
                                 f"sweep points")
            return xs

        workloads = bcast(workloads, "workloads")
        if any(w.cfg.num_keys != workloads[0].cfg.num_keys
               for w in workloads):
            raise ValueError("all sweep points must share num_keys "
                             "(array shapes are static)")
        if any(w.cfg.key_size != workloads[0].cfg.key_size
               for w in workloads):
            raise ValueError("all sweep points must share key_size")
        offered = (bcast(offered, "offered_rps") if offered
                   else [w.cfg.offered_rps for w in workloads])
        ratios = (bcast(ratios, "write_ratios") if ratios
                  else [w.cfg.write_ratio for w in workloads])
        seeds = bcast(list(seeds) if seeds is not None
                      else [cfg.seed + i for i in range(n)], "seeds")

        self.device = resolve_device(device)
        for w in workloads:
            if w.device != self.device:
                raise ValueError(f"a workload lives on {w.device}, the "
                                 f"fleet on {self.device}")
        if draws is None:
            draws = [cl.TorchDraws(s, self.device) for s in seeds]
        draws = bcast(list(draws), "draws")
        if len({id(d) for d in draws}) != n:
            raise ValueError("every sweep point needs its own draw source")

        self.cfg = cfg
        self.workloads = workloads
        self.n_points = n
        self.server_cfg = make_server_config(cfg)
        self.client_cfg = make_client_config(cfg)
        self.key_size = workloads[0].cfg.key_size
        self.controllers = [
            CacheController(ControllerConfig(
                active_size=cfg.cache_entries, max_size=cfg.cache_entries))
            for _ in range(n)]
        self.carry = tree_stack([
            init_carry(cfg, self.server_cfg, self.client_cfg,
                       workloads[i].cfg.num_keys, offered[i], ratios[i], (),
                       self.device)
            for i in range(n)])._replace(draws=FleetDraws(draws))
        self.chunk = FleetChunk(cfg, self.server_cfg, self.client_cfg,
                                self.key_size, self.device,
                                chunk_graphs(self.device, graphs), n)
        self.refresh_workloads()

    def refresh_workloads(self) -> None:
        """Re-stack the workload arrays after host-side churn
        (``Workload.hot_in_swap``, Fig. 18)."""
        self._wl, self._wl_axes = self._wl_and_axes()
        self.chunk.set_wl_dims(self._wl_axes)

    def _wl_and_axes(self) -> tuple[WorkloadArrays, WorkloadArrays]:
        """Stack workload leaves only where points differ (else share)."""
        ws = self.workloads
        same_cdf = all((w.cfg.zipf_alpha, w.cfg.num_keys)
                       == (ws[0].cfg.zipf_alpha, ws[0].cfg.num_keys)
                       for w in ws)
        same_vlen = all((w.cfg.value_sizes, w.cfg.value_seed, w.cfg.num_keys)
                        == (ws[0].cfg.value_sizes, ws[0].cfg.value_seed,
                            ws[0].cfg.num_keys) for w in ws)
        same_perm = all(w is ws[0] or np.array_equal(w._perm_np,
                                                     ws[0]._perm_np)
                        for w in ws)
        cdf = ws[0].cdf if same_cdf else torch.stack([w.cdf for w in ws])
        perm = ws[0].perm if same_perm else torch.stack([w.perm for w in ws])
        vlen = ws[0].vlen if same_vlen else torch.stack([w.vlen for w in ws])
        axes = WorkloadArrays(cdf=None if same_cdf else 0,
                              perm=None if same_perm else 0,
                              vlen=None if same_vlen else 0)
        return WorkloadArrays(cdf=cdf, perm=perm, vlen=vlen), axes

    # -------------------------------------------------------- dynamic knobs
    def _per_point(self, x) -> np.ndarray:
        return np.broadcast_to(np.asarray(x, np.float32),
                               (self.n_points,)).copy()

    def set_offered(self, rps) -> None:
        """Per-point offered load (a scalar broadcasts), the reference's
        float32 product."""
        lam = self._per_point(rps) * np.float32(self.cfg.window_us * 1e-6)
        self.carry = self.carry._replace(
            offered=torch.from_numpy(lam).to(self.device))

    def set_write_ratio(self, r) -> None:
        self.carry = self.carry._replace(
            write_ratio=torch.from_numpy(self._per_point(r)).to(self.device))

    def reset_stats(self) -> None:
        """Zero every point's client histograms and counters."""
        old = self.carry.clients
        fresh = cl.init_clients(self.client_cfg, self.device)
        fresh = tree_stack([fresh] * self.n_points)
        self.carry = self.carry._replace(clients=fresh._replace(
            next_seq=old.next_seq, crn_kidx=old.crn_kidx, crn_n=old.crn_n))

    # ------------------------------------------------------------- preload
    def preload(self, keys: Sequence[np.ndarray] | None = None) -> None:
        """Install each point's hot set on the host, then (OrbitCache) run
        16 warm-up windows batched."""
        c = self.cfg
        if c.scheme == "nocache":
            return
        if keys is None:
            k = (c.cache_entries if c.scheme == "orbitcache"
                 else c.netcache_entries)
            keys = [w.hottest_keys(k) for w in self.workloads]
        if c.scheme == "orbitcache":
            pols, fbs = [], []
            for i in range(self.n_points):
                pol, fetches = self.controllers[i].preload(
                    tree_take(self.carry.policy, i), np.asarray(keys[i]))
                pols.append(pol)
                fbs.append(build_fetch_batch(c, self.workloads[i].vlen,
                                             fetches))
            self.carry = self.carry._replace(policy=tree_stack(pols),
                                             fetch=tree_stack(fbs))
            self.run_windows(16)
        elif c.scheme == "netcache":
            pols, self._installed = [], []
            for i in range(self.n_points):
                ks = np.asarray(keys[i])
                st, n = netcache_install(
                    tree_take(self.carry.policy, i), ks,
                    self.workloads[i].vlen_np[ks], key_size=self.key_size,
                    value_limit=c.netcache_value_limit)
                pols.append(st)
                self._installed.append(n)
            self.carry = self.carry._replace(policy=tree_stack(pols))

    # ------------------------------------------------------------------ run
    def run_windows(self, n: int) -> dict[str, np.ndarray]:
        """Advance every point ``n`` windows; traces are ``[N, n, ...]``
        numpy arrays with the reference's dtypes.  ``self.carry`` then is
        the chunk's buffers (clone to keep)."""
        self.carry, m = self.chunk(self._wl, self.carry, n)
        return _points_major(to_numpy(m))._asdict()

    def run_periods(self, n_periods: int,
                    period_w: int) -> dict[str, np.ndarray]:
        """Advance every point ``n_periods`` control-plane periods of
        ``period_w`` windows, the cache updates on the device with
        ``active_size`` carried per point.  Traces are ``[N, n_periods *
        period_w, ...]``; ``_last_update`` is ``[N, n_periods, ...]``."""
        self.carry, act, m, upds = self.chunk.controller_chunk(
            self._wl, self.carry, [c.active_size for c in self.controllers],
            self.controllers[0].cfg, n_periods, period_w)
        for c, a in zip(self.controllers, act.tolist()):
            c.active_size = int(a)
        self._last_update = _points_major(to_numpy(upds))
        return _points_major(to_numpy(m))._asdict()

    def run(self, sim_seconds: float, chunk_windows: int = 256,
            controller_period_s: float | None = None) -> list[SimResult]:
        """Run every point for ``sim_seconds``; one SimResult per point.

        With ``controller_period_s`` an OrbitCache fleet runs whole
        periods, every point's cache updates on the device (batched Fig.
        18); otherwise the hot set stays as preloaded (Figs. 9, 11, 13)."""
        c = self.cfg
        total = int(round(sim_seconds / (c.window_us * 1e-6)))
        period_w = period_windows(controller_period_s, c.window_us)
        counts = []
        windows, periods = counting(self.chunk, counts, self.run_windows,
                                    self.run_periods)
        traces = chunked_run(total, chunk_windows, period_w,
                             c.scheme == "orbitcache", periods, windows)
        merged = {k: np.concatenate([t[k] for t in traces], axis=1)
                  for k in traces[0]}
        cs = self.carry.clients
        hist_sw = to_numpy(cs.hist_switch, "hist_switch")
        hist_srv = to_numpy(cs.hist_server, "hist_server")
        return [SimResult(window_us=c.window_us,
                          traces={k: v[i] for k, v in merged.items()},
                          hist_switch=hist_sw[i], hist_server=hist_srv[i],
                          info=dict(scheme=c.scheme, point=i,
                                    active_size=self.controllers[i]
                                    .active_size),
                          write_path=write_path_of(counts, i))
                for i in range(self.n_points)]


# ---------------------------------------------------------------------------
# fabric mode: vmapped two-tier (racks + spine) sweeps
# ---------------------------------------------------------------------------
class BatchedFabricSimulator:
    """N whole fabrics (R racks + spine each) advancing in lockstep, one
    per sweep point: the points share the rack and fabric geometry and the
    workload, and may differ in rack-local fraction, offered load and
    seeds (the locality sweep runs its points this way).

    The window is ``fabric_sim.fabric_window`` under ``torch.func.vmap``
    over the points, with the racks vmapped again inside: each kernel stays
    ONE launch per call site for all points and racks (the points ops'
    batching rules, ``repro_torch.kernels``).  Args are the reference's,
    plus ``device``, ``draws`` (one ``FabricDraws`` per point; default each
    point's serial fabric's) and ``graphs``."""

    def __init__(self, cfg: RackConfig, fcfg, wl: Workload,
                 local_fracs: Sequence[float] | None = None,
                 offered_rps: Sequence[float] | float | None = None,
                 seeds: Sequence[int] | None = None,
                 n_points: int | None = None, device=None, draws=None,
                 graphs: bool | None = None):
        from .fabric_sim import FabricChunk, FabricSimulator

        n = max(len(local_fracs) if local_fracs is not None else 1,
                len(offered_rps) if isinstance(offered_rps, (list, tuple))
                else 1,
                len(seeds) if seeds is not None else 1,
                len(draws) if draws is not None else 1, n_points or 1)

        def bcast(xs, what):
            xs = list(xs)
            if len(xs) == 1:
                return xs * n
            if len(xs) != n:
                raise ValueError(f"{what}: got {len(xs)} entries for {n} "
                                 f"sweep points")
            return xs

        fracs = bcast(local_fracs if local_fracs is not None
                      else [fcfg.local_frac], "local_fracs")
        seeds = bcast(seeds if seeds is not None
                      else [cfg.seed + 1000 * i for i in range(n)], "seeds")
        if offered_rps is not None and np.isscalar(offered_rps):
            offered_rps = [float(offered_rps)]
        offered = (bcast(offered_rps, "offered_rps")
                   if offered_rps is not None else None)
        draws = bcast(draws, "draws") if draws is not None else [None] * n
        if draws[0] is not None and len({id(d) for d in draws}) != n:
            raise ValueError("every sweep point needs its own draw source")
        self.cfg, self.fcfg, self.wl = cfg, fcfg, wl
        self.n_points = n
        self.device = resolve_device(device)
        # each point a serial fabric (the host-side preload is per point),
        # stacked after the preload
        self._sims = [
            FabricSimulator(dataclasses.replace(cfg, seed=seeds[i]), fcfg,
                            wl, device=self.device, draws=draws[i],
                            graphs=False)
            for i in range(n)]
        for i, sim in enumerate(self._sims):
            sim.set_local_frac(fracs[i])
            if offered is not None:
                sim.set_offered(offered[i])
        s0 = self._sims[0]
        self.server_cfg, self.client_cfg = s0.server_cfg, s0.client_cfg
        self.key_size = s0.key_size
        self.carry = None              # stacked at the preload
        self.chunk = FabricChunk(cfg, fcfg, self.server_cfg, self.client_cfg,
                                 self.key_size, self.device,
                                 chunk_graphs(self.device, graphs), n)

    def preload(self, warm_windows: int = 16) -> None:
        """Each point's host-side table surgery, then the warm-up windows
        through the batched chunk."""
        if self._sims is None:
            raise RuntimeError("fabric sweep already stacked — preload once, "
                               "before the first run_windows()")
        for sim in self._sims:
            sim.preload(warm_windows=0)
        self._stack()
        if self.cfg.scheme == "orbitcache" and warm_windows > 0:
            self.run_windows(warm_windows)

    def _stack(self) -> None:
        from .fabric_sim import BatchedFabricDraws

        sims = self._sims
        self.carry = tree_stack([s.carry for s in sims])._replace(
            draws=BatchedFabricDraws(s.carry.draws for s in sims))
        self.controllers = [s.controllers for s in sims]
        self.spine_controllers = [s.spine_controller for s in sims]
        # the per-point carries are dead once stacked
        self._sims = None

    def run_windows(self, n: int) -> dict[str, np.ndarray]:
        """Advance every fabric ``n`` windows; rack traces are ``[N, n, R,
        ...]``, spine traces ``[N, n]``.  ``self.carry`` then is the
        chunk's buffers (clone to keep)."""
        from .fabric_sim import fabric_metrics_dict

        if self.carry is None:
            self._stack()
        self.carry, m = self.chunk(self.wl.arrays, self.carry, n)
        return fabric_metrics_dict(_points_major(to_numpy(m)))

    def run_periods(self, n_periods: int,
                    period_w: int) -> dict[str, np.ndarray]:
        """Advance every fabric ``n_periods`` control-plane periods, every
        point's rack controllers and spine controller on the device (active
        sizes ``[N, R]`` and ``[N]``)."""
        from .fabric_sim import fabric_metrics_dict

        if self.carry is None:
            self._stack()
        self.carry, (ra, sa), m, _ = self.chunk.controller_chunk(
            self.wl.arrays, self.carry,
            ([[c.active_size for c in cs] for cs in self.controllers],
             [s.active_size for s in self.spine_controllers]),
            (self.controllers[0][0].cfg, self.spine_controllers[0].cfg),
            n_periods, period_w)
        for cs, row in zip(self.controllers, ra.tolist()):
            for c, a in zip(cs, row):
                c.active_size = int(a)
        for s, a in zip(self.spine_controllers, sa.tolist()):
            s.active_size = int(a)
        return fabric_metrics_dict(_points_major(to_numpy(m)))
