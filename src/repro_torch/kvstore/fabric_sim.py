"""Two-tier cross-rack fabric simulator (port of
``repro.kvstore.fabric_sim``): R racks under one shared spine switch.

Each rack owns a copy of the keyspace; a request targets its own rack with
probability ``local_frac`` (a carry scalar) and a uniformly random other
rack otherwise.  Per window (:func:`fabric_window`):

  1. every rack draws its open-loop client batch from its own draw source
     (the standalone rack's draws: the locality-1.0 guarantee);
  2. remote request lanes leave the rack ingress and compact into the
     spine ingress (:func:`repro_torch.core.fabric.exchange_to_spine`),
     re-keyed to their global identity ``kidx * R + home``;
  3. the spine runs its own scheme over the global hot set: OrbitCache
     (``pipeline.window_pipeline``, one ``kernels.subround`` a subround),
     NetCache or NoCache, and serves its hits;
  4. spine misses fall through to the owning rack's forward lanes
     (:func:`~repro_torch.core.fabric.exchange_to_racks`), back on local
     keys, their timestamps debited four fabric crossings;
  5. every rack runs ``simulator.process_window`` under ``torch.func.vmap``
     over the rack axis, so each rack kernel is ONE launch for all racks.

Random draws (the RNG seam): each rack's client draws come from its own
source (a :class:`~repro_torch.kvstore.fleet.FleetDraws` over R sources)
and the target racks from a target source (:class:`TorchTargets`, Philox
seeded ``cfg.seed + 0x0FAB`` as the reference seeds ``fabric_rng``, or
:class:`ReplayTargets`, the reference's ``(u, o)`` draws); both are taken
before the vmapped racks, bundled in :class:`FabricDraws`.

On the card a chunk is a CUDA graph of one fabric window, and with a
controller period one fabric period boundary (:class:`FabricChunk`, a
:class:`~repro_torch.kvstore.simulator.CompiledChunk`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.baselines import (
    init_netcache, netcache_install, netcache_step, nocache_step,
)
from repro_torch.core import fabric as fb
from repro_torch.core import pipeline
from repro_torch.core.controller import (
    CacheController, ControllerConfig, controller_step,
)
from repro_torch.core.hashing import hash128_u32, hash128_u32_np, server_of_key
from repro_torch.core.types import (
    COUNTER_DTYPE, OP_R_REQ, OP_W_REQ, ROUTE_SERVER, PacketBatch,
    device_const, empty_batch, init_switch_state, resolve_device, sat_add,
)
from repro_torch.interop import to_numpy

from . import client as cl
from .fleet import FleetDraws
from .server import server_reports_traced
from .simulator import (
    CompiledChunk, RackConfig, SimCarry, SimResult, build_fetch_batch,
    chunk_graphs, chunked_run, controller_window_apply, generate_requests,
    init_carry, make_client_config, make_server_config, period_windows,
    process_window, tree_stack, tree_take,
)
from .workload import Workload, WorkloadArrays

I32, F32 = torch.int32, torch.float32


@dataclass(frozen=True)
class FabricConfig:
    """Static spine and fabric geometry (the reference's fields and
    defaults)."""

    n_racks: int = 4
    local_frac: float = 0.9         # initial value; dynamic via the carry
    spine_scheme: str = "orbitcache"   # orbitcache | netcache | nocache
    spine_lanes: int = 256          # spine ingress lanes per window
    fwd_lanes: int = 128            # per-rack spine-forward lanes per window
    spine_cache_entries: int = 256  # spine OrbitCache lookup capacity
    spine_queue_size: int = 8
    spine_max_serves: int = 8
    spine_max_frags: int = 1
    spine_recirc_gbps: float = 400.0
    spine_netcache_table: int = 1 << 15
    spine_netcache_entries: int = 10_000
    spine_netcache_value_limit: int = 64
    spine_hop_us: float = 2.0       # one fabric traversal (each way)
    spine_k_report: int = 16        # per-server report slice the spine
                                    # controller merges


class FabricCarry(NamedTuple):
    racks: SimCarry             # leaves stacked over the rack axis [R];
                                # ``racks.draws`` is ()
    spine: Any                  # SwitchState | NetCacheState | () per scheme
    spine_clients: cl.ClientState  # spine-tier serve accounting
    draws: Any                  # FabricDraws: the racks' client draws and
                                # the target draws (the reference's
                                # ``fabric_rng`` and rack keys)
    local_frac: torch.Tensor    # float32[] (dynamic, sweepable)
    spine_drops: torch.Tensor   # int64[] (uint32) cumulative exchange drops


class FabricWindowMetrics(NamedTuple):
    racks: Any                  # WindowMetrics, leaves [R, ...]
    spine_remote: torch.Tensor  # remote requests offered to the spine
    spine_hits: torch.Tensor    # spine cache hits
    spine_served: torch.Tensor  # requests answered at the spine this window
    spine_fwd: torch.Tensor     # spine egress forwarded down to racks
    spine_in_drops: torch.Tensor   # remote lanes dropped at the spine ingress
    spine_fwd_drops: torch.Tensor  # forwarded lanes dropped at rack buffers


# ---------------------------------------------------------------------------
# the target draws (the RNG seam of ``draw_targets``)
# ---------------------------------------------------------------------------
class TorchTargets:
    """Per-window target draws from a ``torch.Generator`` on ``device``
    (Philox on CUDA): ``u`` float32 uniforms in [0, 1) and ``o`` int32 in
    ``[0, n_racks - 1)``."""

    def __init__(self, seed: int, n_racks: int, device):
        self.device = torch.device(device)
        self.n_racks = n_racks
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def draw(self, shape: tuple[int, ...]):
        u = torch.rand(shape, dtype=F32, device=self.device,
                       generator=self.gen)
        o = torch.randint(0, self.n_racks - 1, shape, dtype=I32,
                          device=self.device, generator=self.gen)
        return u, o

    def reserve(self, n: int) -> None:
        """A generator never runs out."""

    def generators(self) -> list[torch.Generator]:
        return [self.gen]

    def get_state(self) -> torch.Tensor:
        return self.gen.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.gen.set_state(state)


class ReplayTargets:
    """Replays recorded target draws ``u`` float32 and ``o`` int32, each
    ``[W, R, S, L]``; the window is a device index that :meth:`draw` reads
    and advances, as ``client.ReplayDraws`` does."""

    def __init__(self, u, o, device):
        self.u = torch.as_tensor(np.asarray(u, np.float32), device=device)
        self.o = torch.as_tensor(np.asarray(o, np.int32), device=device)
        self.index = torch.zeros(1, dtype=torch.int64, device=device)
        self.pos = 0

    def draw(self, shape: tuple[int, ...]):
        i = self.index
        u = self.u.index_select(0, i)[0]
        o = self.o.index_select(0, i)[0]
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"ReplayTargets: recorded {tuple(u.shape)}, "
                             f"asked for {tuple(shape)}")
        self.index += 1
        return u, o

    def reserve(self, n: int) -> None:
        if self.pos + n > self.u.shape[0]:
            raise IndexError(f"ReplayTargets: {n} windows asked for, "
                             f"{self.u.shape[0] - self.pos} left")
        self.pos += n

    def generators(self) -> list[torch.Generator]:
        return []

    def get_state(self):
        return self.index.clone(), self.pos

    def set_state(self, state) -> None:
        self.index.copy_(state[0])
        self.pos = state[1]


class FabricDraws(FleetDraws):
    """A fabric's draw sources behind the interface a chunk uses
    (``reserve``, ``generators``, ``get_state`` / ``set_state``, over every
    source): the racks' client sources (one each, ``racks``) and the target
    source (``targets``).  :meth:`draw_window` takes one window's draws;
    one rack takes no target draw."""

    def __init__(self, racks: Sequence, targets):
        super().__init__([*racks, targets])
        self.racks = FleetDraws(racks)
        self.targets = targets

    def draw_window(self, offered: torch.Tensor, b: int,
                    shape: tuple[int, ...]):
        """``(n [R], u [R, b], w [R, b], tu, to)``, the target draws
        ``[R, S, L]`` (None for one rack)."""
        n, u, w = self.racks.draw_all(offered, b)
        tu, to = (self.targets.draw(shape) if len(self.racks.sources) > 1
                  else (None, None))
        return n, u, w, tu, to


def target_shape(cfg: RackConfig, fcfg: FabricConfig,
                 client_cfg: cl.ClientConfig) -> tuple[int, int, int]:
    """``[R, S, L]`` of the client batch (requests and CRN lanes)."""
    return (fcfg.n_racks, cfg.subrounds,
            (client_cfg.batch + client_cfg.crn_width) // cfg.subrounds)


def init_spine_policy(cfg: RackConfig, fcfg: FabricConfig, device=None):
    if fcfg.spine_scheme == "orbitcache":
        return init_switch_state(fcfg.spine_cache_entries,
                                 fcfg.spine_queue_size, cfg.value_pad,
                                 fcfg.spine_max_frags, device)
    if fcfg.spine_scheme == "netcache":
        return init_netcache(fcfg.spine_netcache_table,
                             fcfg.spine_netcache_value_limit, device)
    if fcfg.spine_scheme == "nocache":
        return ()
    raise ValueError(f"unknown spine scheme {fcfg.spine_scheme!r}")


# ---------------------------------------------------------------------------
# the fabric's float32 sites, in the reference's compiled order
# ---------------------------------------------------------------------------
# XLA folds the constants ``2.0 * hop``, ``4.0 * hop`` and ``window /
# subrounds`` (as ``window * (1 / subrounds)``, exact for the power-of-two
# subround counts the clients allow); the port folds them the same way in
# float32 and keeps every remaining operation in the reference's order.
def spine_serve_time(now: torch.Tensor, order: torch.Tensor,
                     intervals: torch.Tensor, window_us: float,
                     hop_us: float) -> torch.Tensor:
    """float32[S, C, J] time an OrbitCache spine serves grid slot
    ``order`` of subround r: ``now + 2.0 * hop + (r + 0.5) * window /
    subrounds + (order + 1.0) * interval[r]`` (up to the spine and the
    reply back down), as ``((now + 2hop) + (r + 0.5) * K) + ...``."""
    dev, subrounds = order.device, order.shape[0]
    f32 = lambda v: device_const(v, F32, dev)
    k_sub = np.float32(window_us) * (np.float32(1.0)
                                     / np.float32(subrounds))
    r_idx = torch.arange(subrounds, dtype=F32, device=dev)[:, None, None]
    two_hop = np.float32(2.0) * np.float32(hop_us)
    return (((now + f32(two_hop)) + (r_idx + f32(0.5)) * f32(k_sub))
            + (order.to(F32) + f32(1.0)) * intervals[:, None, None])


def fall_through_ts(ts: torch.Tensor, hop_us: float) -> torch.Tensor:
    """A spine miss's timestamp debited four fabric crossings (down via
    the spine and the reply's return): ``ts - 4.0 * hop``."""
    four_hop = np.float32(4.0) * np.float32(hop_us)
    return ts - device_const(four_hop, F32, ts.device)


def spine_switch_latency(shape, base_rtt_us: float, hop_us: float,
                         device) -> torch.Tensor:
    """A NetCache spine hit's latency, float32 ``shape``: ``1.0 +
    base_rtt + 2.0 * hop``."""
    f32 = lambda v: device_const(v, F32, device)
    two_hop = np.float32(2.0) * np.float32(hop_us)
    return ((torch.full(shape, 1.0, dtype=F32, device=device)
             + f32(base_rtt_us)) + f32(two_hop))


# ---------------------------------------------------------------------------
# the fabric window step (pure; shared by serial and batched simulators)
# ---------------------------------------------------------------------------
def fabric_window_step(cfg: RackConfig, fcfg: FabricConfig, server_cfg,
                       client_cfg: cl.ClientConfig, key_size: int,
                       wl: WorkloadArrays, carry: FabricCarry,
                       donate: bool = False,
                       ) -> tuple[FabricCarry, FabricWindowMetrics]:
    """One fabric window: the draws from ``carry.draws``, then
    :func:`fabric_window`."""
    given = carry.draws.draw_window(carry.racks.offered, client_cfg.batch,
                                    target_shape(cfg, fcfg, client_cfg))
    return fabric_window(cfg, fcfg, server_cfg, client_cfg, key_size, wl,
                         carry, given, donate)


def fabric_window(cfg: RackConfig, fcfg: FabricConfig, server_cfg,
                  client_cfg: cl.ClientConfig, key_size: int,
                  wl: WorkloadArrays, carry: FabricCarry, given,
                  donate: bool = False,
                  ) -> tuple[FabricCarry, FabricWindowMetrics]:
    """One fabric window on the draws ``given`` (``FabricDraws.
    draw_window``'s; ``donate``: the racks' key versions are updated in
    place, as ``simulator.window_step``'s).  vmap-clean: the batched
    fabric maps it over its points."""
    r_fab, subrounds = fcfg.n_racks, cfg.subrounds
    n, u, w, tu, to = given
    dev = carry.local_frac.device
    isum = lambda x: torch.sum(x, dtype=I32)
    now = carry.racks.now[0]                  # racks advance in lockstep
    racks = carry.racks._replace(draws=())

    # ---- 1. per-rack client generation (each rack's own draws) ------------
    def gen_one(c_i, n_i, u_i, w_i):
        return generate_requests(cfg, client_cfg, wl, c_i._replace(
            draws=cl.GivenDraws(n_i, u_i, w_i)))

    clientss, reqss = torch.func.vmap(gen_one)(racks, n, u, w)

    # ---- 2. locality draws + spine-bound diversion -------------------------
    shape = tuple(reqss.op.shape)
    tgt = fb.targets_from_draws(tu, to, r_fab, carry.local_frac, shape, dev)
    src = fb.source_racks(r_fab, 3, dev)
    is_req = reqss.valid & ((reqss.op == OP_R_REQ) | (reqss.op == OP_W_REQ))
    remote = is_req & (tgt != src)
    local_reqs = reqss._replace(valid=reqss.valid & ~remote)

    spine_row = empty_batch(fcfg.spine_lanes // subrounds, cfg.value_pad, dev)
    spine_sub, s_writer, s_written, in_drops = fb.exchange_to_spine(
        reqss, remote, spine_row)
    tgt_s = torch.where(s_written, torch.take_along_dim(
        fb.racks_to_rows(tgt), s_writer.long(), dim=1), 0)
    # re-key to the global identity: the spine caches (kidx, home) pairs
    gk = fb.global_key(spine_sub.kidx, tgt_s, r_fab)
    spine_sub = spine_sub._replace(kidx=gk, hkey=hash128_u32(gk),
                                   server=tgt_s)

    # ---- 3. the spine switch pass ------------------------------------------
    spine_clients = carry.spine_clients
    if fcfg.spine_scheme == "orbitcache":
        spine2, outs, intervals = pipeline.window_pipeline(
            carry.spine, spine_sub, recirc_gbps=fcfg.spine_recirc_gbps,
            window_us=cfg.window_us, subrounds=subrounds,
            max_serves=fcfg.spine_max_serves, key_size=key_size)
        routes, flags, grids, stats = outs.route, outs.flag, outs.grid, \
            outs.stats
        serve_time = spine_serve_time(now, grids.order, intervals,
                                      cfg.window_us, fcfg.spine_hop_us)
        j = fcfg.spine_max_serves
        spine_clients = cl.account_switch_served(
            spine_clients, client_cfg, grids.served.reshape(-1, j),
            grids.req_kidx.reshape(-1, j), grids.ts.reshape(-1, j),
            grids.kidx.reshape(-1), serve_time.reshape(-1, j))
        spine_hits, spine_served = isum(stats.n_hit), isum(stats.n_served)
    elif fcfg.spine_scheme == "netcache":
        spine2, ys = carry.spine, []
        for r in range(subrounds):            # the reference's lax.scan
            spine2, *y = netcache_step(
                spine2, PacketBatch(*(a[r] for a in spine_sub)))
            ys.append(y)
        routes, flags, sreps, n_hits = (torch.stack(x) for x in zip(*ys))
        srep_flat = sreps.reshape(-1)
        lat = spine_switch_latency(srep_flat.shape, client_cfg.base_rtt_us,
                                   fcfg.spine_hop_us, dev)
        bucket = torch.where(srep_flat, cl.lat_bucket(lat), cl.LAT_BUCKETS)
        spine_served = isum(srep_flat)
        spine_clients = spine_clients._replace(
            hist_switch=sat_add(spine_clients.hist_switch,
                                cl._bucket_counts(bucket)),
            rx_switch=sat_add(spine_clients.rx_switch, spine_served))
        spine_hits = isum(n_hits)
    else:  # nocache spine: a pure forwarding fabric
        spine2, ys = carry.spine, []
        for r in range(subrounds):
            spine2, *y = nocache_step(
                spine2, PacketBatch(*(a[r] for a in spine_sub)))
            ys.append(y)
        routes, flags = (torch.stack(x) for x in zip(*ys))
        spine_hits = spine_served = torch.zeros((), dtype=I32, device=dev)

    # ---- 4. spine misses fall through to the owning rack's ToR -------------
    fwd_mask = (routes == ROUTE_SERVER) & spine_sub.valid
    lk, home = fb.split_global_key(spine_sub.kidx, r_fab)
    fwd_pk = spine_sub._replace(
        kidx=lk, hkey=hash128_u32(lk),
        server=server_of_key(lk, cfg.num_servers), flag=flags,
        ts=fall_through_ts(spine_sub.ts, fcfg.spine_hop_us), valid=fwd_mask)
    fwd_row = empty_batch(fcfg.fwd_lanes // subrounds, cfg.value_pad, dev)
    rack_fwd, fwd_drops = fb.exchange_to_racks(fwd_pk, fwd_mask, home, r_fab,
                                               fwd_row)

    # ---- 5. per-rack ToR + servers + clients (the standalone window) -------
    def rack_one(c_i, clients_i, reqs_i, local_i, fwd_i):
        sub = PacketBatch(*(torch.cat(xs, dim=1) for xs in
                            zip(local_i, c_i.pending, c_i.fetch, fwd_i)))
        return process_window(cfg, server_cfg, client_cfg, key_size, c_i,
                              clients_i, reqs_i, sub, donate)

    racks2, rack_metrics = torch.func.vmap(rack_one)(
        racks, clientss, reqss, local_reqs, rack_fwd)

    new_carry = FabricCarry(
        racks=racks2, spine=spine2, spine_clients=spine_clients,
        draws=carry.draws, local_frac=carry.local_frac,
        spine_drops=sat_add(carry.spine_drops, in_drops + fwd_drops))
    metrics = FabricWindowMetrics(
        racks=rack_metrics, spine_remote=isum(remote), spine_hits=spine_hits,
        spine_served=spine_served, spine_fwd=isum(fwd_mask),
        spine_in_drops=in_drops, spine_fwd_drops=fwd_drops)
    return new_carry, metrics


def fabric_controller_apply(cfg: RackConfig, fcfg: FabricConfig,
                            ctrl_cfg: ControllerConfig,
                            spine_ctrl_cfg: ControllerConfig,
                            wl: WorkloadArrays, carry: FabricCarry,
                            rack_active: torch.Tensor,
                            spine_active: torch.Tensor):
    """One control-plane period boundary across the whole fabric:
    ``(carry', rack_active' int32[R], spine_active' int32[])``.

    Every rack's servers report their top-k (trackers reset).  Each
    OrbitCache ToR runs the standalone rack's boundary
    (``controller_window_apply``, vmapped over the racks).  An OrbitCache
    spine runs the global controller in ``install_live`` mode on the
    reports, cut to ``min(spine k_report, k_report)`` per server and
    re-keyed to their global identities."""
    r_fab = fcfg.n_racks
    racks = carry.racks
    if cfg.scheme == "orbitcache":
        def one(c_i, a_i):
            new, act, _, tops = controller_window_apply(cfg, ctrl_cfg, wl,
                                                        c_i, a_i)
            return new, act, tops

        racks, rack_active, (top_k, top_e) = torch.func.vmap(one)(
            racks, rack_active)
    else:
        servers2, top_k, top_e = torch.func.vmap(
            lambda s: server_reports_traced(s, ctrl_cfg.k_report))(
            racks.servers)
        racks = racks._replace(servers=servers2)

    if fcfg.spine_scheme == "orbitcache":
        k_spine = min(spine_ctrl_cfg.k_report, ctrl_cfg.k_report)
        tk, te = top_k[:, :, :k_spine], top_e[:, :, :k_spine]
        rid = fb.source_racks(r_fab, 3, tk.device)
        rv = tk >= 0
        gk = torch.where(rv, tk * r_fab + rid, -1)
        gvlen = torch.where(rv, wl.vlen[torch.clamp(tk, min=0).long()], 0)
        sp = carry.spine
        sp2, spine_active, _ = controller_step(
            sp, gk.reshape(-1), te.reshape(-1), sp.counters.overflow,
            sp.counters.cached_reqs, spine_active, spine_ctrl_cfg,
            install_live=True, report_vlen=gvlen.reshape(-1))
        carry = carry._replace(spine=sp2)
    return carry._replace(racks=racks), rack_active, spine_active


# ---------------------------------------------------------------------------
# the batched fabric's steps: every point's draws, then the window vmapped
# ---------------------------------------------------------------------------
def batched_fabric_window_step(cfg, fcfg, server_cfg, client_cfg, key_size,
                               wl, carry, donate=False):
    """One window of every point's fabric: ``carry.draws`` is a
    :class:`BatchedFabricDraws`, every other leaf and the metrics
    ``[P, ...]`` (the racks' ``[P, R, ...]``)."""
    given = carry.draws.draw_window(carry.racks.offered, client_cfg.batch,
                                    target_shape(cfg, fcfg, client_cfg))

    def one(carry_i, given_i):
        return fabric_window(cfg, fcfg, server_cfg, client_cfg, key_size, wl,
                             carry_i, given_i, donate)

    new, m = torch.func.vmap(one)(carry._replace(draws=()), given)
    return new._replace(draws=carry.draws), m


def batched_fabric_controller_apply(cfg, fcfg, ctrl_cfg, spine_ctrl_cfg, wl,
                                    carry, rack_active, spine_active):
    """One period boundary of every point (active sizes ``[P, R]`` and
    ``[P]``)."""
    def one(c, a, s):
        return fabric_controller_apply(cfg, fcfg, ctrl_cfg, spine_ctrl_cfg,
                                       wl, c, a, s)

    new, ra, sa = torch.func.vmap(one)(carry._replace(draws=()), rack_active,
                                       spine_active)
    return new._replace(draws=carry.draws), ra, sa


class BatchedFabricDraws(FleetDraws):
    """The points' :class:`FabricDraws`, one each, behind the chunk's
    interface; :meth:`draw_window` stacks one window's draws of every
    point."""

    def draw_window(self, offered: torch.Tensor, b: int,
                    shape: tuple[int, ...]):
        ds = [d.draw_window(offered[i], b, shape)
              for i, d in enumerate(self.sources)]
        return tuple(None if x[0] is None else torch.stack(x)
                     for x in zip(*ds))


class FabricChunk(CompiledChunk):
    """A chunk of fabric windows (and period boundaries):
    :class:`CompiledChunk`'s buffers, capture and replay with the fabric's
    bodies.  ``active`` is ``(rack_active int32[R], spine_active
    int32[])``, a period leaves no update (``()``), the controller configs
    are the pair ``(rack, spine)``.  With ``n_points`` the bodies are the
    batched fabric's (every leaf ``[P, ...]``)."""

    def __init__(self, cfg, fcfg: FabricConfig, server_cfg, client_cfg,
                 key_size: int, device, graphs: bool,
                 n_points: int | None = None):
        super().__init__(cfg, server_cfg, client_cfg, key_size, device,
                         graphs)
        self.fcfg = fcfg
        self.n_points = n_points
        self.sink = None            # a fabric window keeps no counts
        lead = () if n_points is None else (n_points,)
        self.active = (torch.zeros(lead + (fcfg.n_racks,), dtype=I32,
                                   device=device),
                       torch.zeros(lead, dtype=I32, device=device))

    def step(self, wl, carry, donate=False):
        fn = (fabric_window_step if self.n_points is None
              else batched_fabric_window_step)
        return fn(self.cfg, self.fcfg, self.server_cfg, self.client_cfg,
                  self.key_size, wl, carry, donate)

    def apply(self, wl, carry, active):
        fn = (fabric_controller_apply if self.n_points is None
              else batched_fabric_controller_apply)
        new, ra, sa = fn(self.cfg, self.fcfg, *self.ctrl_cfg, wl, carry,
                         *active)
        return new, (ra, sa), ()

    def set_active(self, active_size) -> None:
        """``(rack sizes, spine size)``, nested per point when batched."""
        for buf, vals in zip(self.active, active_size, strict=True):
            flat = buf.view(-1)
            for i, v in enumerate(np.asarray(vals).reshape(-1)):
                flat[i].fill_(int(v))


def fabric_metrics_dict(ys: FabricWindowMetrics) -> dict[str, np.ndarray]:
    """A chunk's metrics (numpy) as the reference's trace dict: rack
    metrics as ``rack_<name>``, spine counters under their own names."""
    out = {f"rack_{k}": v for k, v in ys.racks._asdict().items()}
    for k in FabricWindowMetrics._fields:
        if k != "racks":
            out[k] = getattr(ys, k)
    return out


# ---------------------------------------------------------------------------
# spine preload (host-side controller surgery, like the rack preloads)
# ---------------------------------------------------------------------------
def preload_spine(policy, cfg: RackConfig, fcfg: FabricConfig,
                  wl: Workload):
    """Install the global hot set into the spine cache: the hottest
    ``entries // n_racks`` local keys of every rack under their global
    identities, interleaved by popularity rank.  OrbitCache entries go in
    live with version-0 lines; NetCache through its own install path and
    value-size limit."""
    r_fab = fcfg.n_racks
    if fcfg.spine_scheme == "nocache":
        return policy
    per_rack = max(1, (fcfg.spine_cache_entries
                       if fcfg.spine_scheme == "orbitcache"
                       else fcfg.spine_netcache_entries) // r_fab)
    local = wl.hottest_keys(per_rack)
    gkeys = np.concatenate(
        [local.astype(np.int64) * r_fab + t for t in range(r_fab)]
    ).astype(np.int32)
    vlens = np.concatenate([wl.vlen_np[local]] * r_fab)
    # interleave by popularity rank so truncation keeps every rack's head
    order = np.argsort(np.tile(np.arange(len(local)), r_fab), kind="stable")
    gkeys, vlens = gkeys[order], vlens[order]

    if fcfg.spine_scheme == "netcache":
        st, _ = netcache_install(policy, gkeys, vlens,
                                 key_size=wl.cfg.key_size,
                                 value_limit=fcfg.spine_netcache_value_limit)
        return st

    n = min(len(gkeys), fcfg.spine_cache_entries)
    gk = gkeys[:n]
    dev = policy.lookup.kidx.device
    np_of = lambda t: t.detach().cpu().numpy().copy()
    t_of = lambda a: torch.from_numpy(a).to(dev)
    lk, st, orb = policy.lookup, policy.state, policy.orbit
    hkeys, occupied, kidx = np_of(lk.hkeys), np_of(lk.occupied), \
        np_of(lk.kidx)
    valid = np_of(st.valid)
    live, okidx, ovlen = np_of(orb.live), np_of(orb.kidx), np_of(orb.vlen)
    hkeys[:n] = hash128_u32_np(gk).view(np.int32)
    occupied[:n] = True
    kidx[:n] = gk
    valid[:n] = True
    # the fragment-0 line of each entry carries the whole value (spine
    # lines are metadata-served; their value bytes stay zero)
    lines = np.arange(n) * fcfg.spine_max_frags
    live[lines] = True
    okidx[lines] = gk
    ovlen[lines] = vlens[:n]
    return policy._replace(
        lookup=lk._replace(hkeys=t_of(hkeys), occupied=t_of(occupied),
                           kidx=t_of(kidx)),
        state=st._replace(valid=t_of(valid)),
        orbit=orb._replace(live=t_of(live), kidx=t_of(okidx),
                           vlen=t_of(ovlen)))


# ---------------------------------------------------------------------------
# host-side simulators
# ---------------------------------------------------------------------------
@dataclass
class FabricResult:
    """Host-side aggregation of a fabric run."""
    window_us: float
    racks: list[SimResult] = field(default_factory=list)
    spine: dict = field(default_factory=dict)

    def throughput_rps(self, burn_frac: float = 0.25) -> float:
        """Fabric-wide delivered requests/s: rack tiers + the spine tier."""
        total = sum(r.throughput_rps(burn_frac) for r in self.racks)
        sp = self.spine.get("served")
        if sp is not None:
            n = len(sp)
            b = int(n * burn_frac)
            total += float(sp[b:].sum() / ((n - b) * self.window_us * 1e-6))
        return total

    def offered_rps(self, burn_frac: float = 0.25) -> float:
        return sum(r.offered_rps(burn_frac) for r in self.racks)

    def spine_hit_ratio(self, burn_frac: float = 0.25) -> float:
        rem = self.spine["remote"]
        srv = self.spine["served"]
        b = int(len(rem) * burn_frac)
        return float(srv[b:].sum() / max(rem[b:].sum(), 1))


class FabricSimulator:
    """R racks + one spine switch advancing in lockstep.

    The reference's API and argument rules, plus the port's ``device``
    (the CUDA card unless given), ``draws`` (a :class:`FabricDraws`;
    default ``TorchDraws(seeds[i])`` per rack and ``TorchTargets(cfg.seed
    + 0x0FAB)``) and ``graphs`` (CUDA graphs for the chunks, default on a
    CUDA device)."""

    def __init__(self, cfg: RackConfig, fcfg: FabricConfig, wl: Workload,
                 seeds: Sequence[int] | None = None, device=None,
                 draws: FabricDraws | None = None,
                 graphs: bool | None = None):
        if fcfg.spine_lanes % cfg.subrounds or fcfg.fwd_lanes % cfg.subrounds:
            raise ValueError(
                f"spine_lanes ({fcfg.spine_lanes}) and fwd_lanes "
                f"({fcfg.fwd_lanes}) must be multiples of subrounds "
                f"({cfg.subrounds})")
        self.cfg, self.fcfg, self.wl = cfg, fcfg, wl
        self.device = resolve_device(device)
        if wl.device != self.device:
            raise ValueError(f"workload lives on {wl.device}, the fabric on "
                             f"{self.device}")
        self.server_cfg = make_server_config(cfg)
        self.client_cfg = make_client_config(cfg)
        self.key_size = wl.cfg.key_size
        r = fcfg.n_racks
        seeds = (list(seeds) if seeds is not None
                 else [cfg.seed + i for i in range(r)])
        if len(seeds) != r:
            raise ValueError(f"need {r} seeds, got {len(seeds)}")
        self.controllers = [
            CacheController(ControllerConfig(
                active_size=cfg.cache_entries, max_size=cfg.cache_entries))
            for _ in range(r)]
        self.spine_controller = CacheController(ControllerConfig(
            active_size=fcfg.spine_cache_entries,
            max_size=fcfg.spine_cache_entries, k_report=fcfg.spine_k_report))
        dev = self.device
        if draws is None:
            draws = FabricDraws([cl.TorchDraws(s, dev) for s in seeds],
                                TorchTargets(cfg.seed + 0x0FAB, r, dev))
        racks = tree_stack([
            init_carry(cfg, self.server_cfg, self.client_cfg,
                       wl.cfg.num_keys, wl.cfg.offered_rps,
                       wl.cfg.write_ratio, (), dev) for _ in range(r)])
        self.carry = FabricCarry(
            racks=racks, spine=init_spine_policy(cfg, fcfg, dev),
            spine_clients=cl.init_clients(self.client_cfg, dev), draws=draws,
            local_frac=torch.tensor(fcfg.local_frac, dtype=F32, device=dev),
            spine_drops=torch.zeros((), dtype=COUNTER_DTYPE, device=dev))
        self.chunk = FabricChunk(cfg, fcfg, self.server_cfg, self.client_cfg,
                                 self.key_size, dev, chunk_graphs(dev, graphs))

    # -- dynamic knobs (copied in at the next chunk's start, no recapture) --
    def set_local_frac(self, frac: float) -> None:
        self.carry = self.carry._replace(local_frac=torch.tensor(
            frac, dtype=F32, device=self.device))

    def set_offered(self, rps: float) -> None:
        self.carry = self.carry._replace(racks=self.carry.racks._replace(
            offered=torch.full((self.fcfg.n_racks,),
                               rps * self.cfg.window_us * 1e-6, dtype=F32,
                               device=self.device)))

    def reset_stats(self) -> None:
        fresh = cl.init_clients(self.client_cfg, self.device)
        keep = lambda old: dict(next_seq=old.next_seq,
                                crn_kidx=old.crn_kidx, crn_n=old.crn_n)
        racks = self.carry.racks
        self.carry = self.carry._replace(
            racks=racks._replace(clients=tree_stack(
                [fresh] * self.fcfg.n_racks)._replace(**keep(racks.clients))),
            spine_clients=fresh._replace(**keep(self.carry.spine_clients)))

    # ------------------------------------------------------------- preload
    def preload(self, warm_windows: int = 16) -> None:
        """Install rack hot sets and the global spine hot set, then warm
        up (OrbitCache racks: the F-REQs reach the servers and the F-REPs
        install orbit lines)."""
        c, fcfg = self.cfg, self.fcfg
        racks = self.carry.racks
        if c.scheme == "orbitcache":
            pols, fbs = [], []
            for i in range(fcfg.n_racks):
                pol, fetches = self.controllers[i].preload(
                    tree_take(racks.policy, i),
                    self.wl.hottest_keys(c.cache_entries))
                pols.append(pol)
                fbs.append(build_fetch_batch(c, self.wl.vlen, fetches))
            racks = racks._replace(policy=tree_stack(pols),
                                   fetch=tree_stack(fbs))
        elif c.scheme == "netcache":
            ks = self.wl.hottest_keys(c.netcache_entries)
            racks = racks._replace(policy=tree_stack([
                netcache_install(tree_take(racks.policy, i), ks,
                                 self.wl.vlen_np[ks], key_size=self.key_size,
                                 value_limit=c.netcache_value_limit)[0]
                for i in range(fcfg.n_racks)]))
        self.carry = self.carry._replace(
            racks=racks,
            spine=preload_spine(self.carry.spine, c, fcfg, self.wl))
        if c.scheme == "orbitcache" and warm_windows > 0:
            self.run_windows(warm_windows)

    # ------------------------------------------------------------------ run
    def run_windows(self, n: int) -> dict[str, np.ndarray]:
        """Advance the fabric ``n`` windows; rack traces are ``[n, R,
        ...]``.  ``self.carry`` then is the chunk's buffers (clone to
        keep)."""
        self.carry, m = self.chunk(self.wl.arrays, self.carry, n)
        return fabric_metrics_dict(to_numpy(m))

    def run_periods(self, n_periods: int,
                    period_w: int) -> dict[str, np.ndarray]:
        """Advance ``n_periods`` control-plane periods of ``period_w``
        windows, the rack controllers and the global spine controller on
        the device after each (:func:`fabric_controller_apply`)."""
        self.carry, (ra, sa), m, _ = self.chunk.controller_chunk(
            self.wl.arrays, self.carry,
            ([c.active_size for c in self.controllers],
             self.spine_controller.active_size),
            (self.controllers[0].cfg, self.spine_controller.cfg),
            n_periods, period_w)
        for c, a in zip(self.controllers, ra.tolist()):
            c.active_size = int(a)
        self.spine_controller.active_size = int(sa)
        return fabric_metrics_dict(to_numpy(m))

    def run(self, sim_seconds: float, chunk_windows: int = 256,
            controller_period_s: float | None = None) -> FabricResult:
        c = self.cfg
        total = int(round(sim_seconds / (c.window_us * 1e-6)))
        period_w = period_windows(controller_period_s, c.window_us)
        has_ctrl = (c.scheme == "orbitcache"
                    or self.fcfg.spine_scheme == "orbitcache")
        traces = chunked_run(total, chunk_windows, period_w, has_ctrl,
                             self.run_periods, self.run_windows)
        merged = {k: np.concatenate([t[k] for t in traces], axis=0)
                  for k in traces[0]}
        cs, sc = self.carry.racks.clients, self.carry.spine_clients
        hist_sw = to_numpy(cs.hist_switch, "hist_switch")
        hist_srv = to_numpy(cs.hist_server, "hist_server")
        res = FabricResult(window_us=c.window_us)
        for i in range(self.fcfg.n_racks):
            res.racks.append(SimResult(
                window_us=c.window_us,
                traces={k[len("rack_"):]: v[:, i] for k, v in merged.items()
                        if k.startswith("rack_")},
                hist_switch=hist_sw[i], hist_server=hist_srv[i],
                info=dict(scheme=c.scheme, rack=i)))
        res.spine = dict(
            scheme=self.fcfg.spine_scheme,
            active_size=self.spine_controller.active_size,
            remote=merged["spine_remote"], hits=merged["spine_hits"],
            served=merged["spine_served"], fwd=merged["spine_fwd"],
            in_drops=merged["spine_in_drops"],
            fwd_drops=merged["spine_fwd_drops"],
            hist_switch=to_numpy(sc.hist_switch, "hist_switch"),
            rx_switch=int(sc.rx_switch), mismatches=int(sc.mismatches))
        return res
