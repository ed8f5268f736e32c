"""Discrete-time rack simulator (port of ``repro.kvstore.simulator``):
OrbitCache, NetCache and NoCache.

Time advances in windows (default 100 µs).  Each window the clients draw
an open-loop Poisson batch, the switch runs the fused pipeline over the
window's ``subrounds`` (one subround kernel launch each), the storage
servers drain their FIFOs, the clients account the replies, and the
servers' replies become next window's switch ingress.  Every ingress
source is kept subround-major ``[R, L]``.

A chunk of windows is :class:`CompiledChunk`, the counterpart of the
reference's jitted ``lax.scan`` chunk: on the card, one window is a CUDA
graph replayed once per window, and nothing in a chunk waits for the
device until the caller reads the metrics.  With a controller period, a
chunk is whole periods: ``period_w`` windows, then one device-side cache
update (:func:`controller_window_apply`, a second graph), and the host
reads only the metrics, the updates and ``active_size`` at the end of the
chunk.  The ``netcache`` and ``nocache`` switch passes are a few
element-wise ops per subround and launch no kernel.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import kernels as kn
from repro_torch.baselines import (
    init_netcache, netcache_install, netcache_step, nocache_step,
)
from repro_torch.core import pipeline
from repro_torch.core.controller import (
    CacheController, ControllerConfig, controller_step,
)
from repro_torch.core.hashing import hash128_u32, server_of_key
from repro_torch.core.types import (
    OP_F_REQ, OP_NONE, ROUTE_CLIENT, ROUTE_SERVER, PacketBatch, device_const,
    empty_batch, init_switch_state, resolve_device, sat_add,
)
from repro_torch.interop import to_numpy

from . import client as cl
from .server import (
    ServerConfig, ServerState, init_servers, server_reports,
    server_reports_traced, server_step,
)
from .workload import Workload, WorkloadArrays

HDR_BYTES = pipeline.HDR_BYTES
I32, F32 = torch.int32, torch.float32


@dataclass(frozen=True)
class RackConfig:
    scheme: str = "orbitcache"          # orbitcache | netcache | nocache
    window_us: float = 100.0
    subrounds: int = 4
    max_serves: int = 8
    cache_entries: int = 128
    queue_size: int = 8
    value_pad: int = 1438
    max_frags: int = 1
    recirc_gbps: float = 100.0
    netcache_entries: int = 10_000
    netcache_table: int = 1 << 15
    netcache_value_limit: int = 64
    num_servers: int = 32
    server_rps: float = 100_000.0
    server_queue: int = 64
    client_batch: int = 768
    num_clients: int = 4
    fetch_lanes: int = 256
    track_popularity: bool = False
    seed: int = 0


class WindowMetrics(NamedTuple):
    tx: torch.Tensor
    rx_switch: torch.Tensor
    rx_server: torch.Tensor     # int64 (the reference's uint32 delta)
    served: torch.Tensor
    dropped: torch.Tensor
    backlog: torch.Tensor
    hits: torch.Tensor
    overflow: torch.Tensor
    installs: torch.Tensor
    crn: torch.Tensor
    mismatches: torch.Tensor    # int64 (uint32 lifetime counter)
    fwd: torch.Tensor


class SimCarry(NamedTuple):
    policy: Any                 # SwitchState | NetCacheState | () for nocache
    servers: ServerState
    clients: cl.ClientState
    pending: PacketBatch        # server replies awaiting the switch, [R, Lp]
    fetch: PacketBatch          # controller-injected F-REQs, [R, Lf]
    draws: Any                  # the random-draw source (TorchDraws, ...)
    now: torch.Tensor           # float32 µs
    offered: torch.Tensor       # float32 mean requests per window
    write_ratio: torch.Tensor   # float32


def make_server_config(cfg: RackConfig) -> ServerConfig:
    return ServerConfig(
        num_servers=cfg.num_servers, queue_depth=cfg.server_queue,
        cap_per_window=max(1, int(round(cfg.server_rps * cfg.window_us
                                        * 1e-6))),
        value_pad=cfg.value_pad, max_frags=cfg.max_frags,
        track_popularity=cfg.track_popularity,
    )


def make_client_config(cfg: RackConfig) -> cl.ClientConfig:
    return cl.ClientConfig(batch=cfg.client_batch, num_clients=cfg.num_clients,
                           value_pad=cfg.value_pad, subrounds=cfg.subrounds)


def interleave(batch: PacketBatch, subrounds: int) -> PacketBatch:
    """Flat [W] lanes -> subround-major [R, W // R] (lane i -> row i % R)."""
    def f(a):
        return a.reshape((a.shape[0] // subrounds, subrounds) + a.shape[1:]
                         ).transpose(0, 1).contiguous()
    return PacketBatch(*(f(a) for a in batch))


def _reply_width(cfg: RackConfig, server_cfg: ServerConfig) -> tuple[int, int]:
    w = cfg.num_servers * server_cfg.cap_per_window * cfg.max_frags
    return w, (-w) % cfg.subrounds


def init_policy(cfg: RackConfig, device):
    if cfg.scheme == "orbitcache":
        return init_switch_state(cfg.cache_entries, cfg.queue_size,
                                 cfg.value_pad, cfg.max_frags, device)
    if cfg.scheme == "netcache":
        return init_netcache(cfg.netcache_table, cfg.netcache_value_limit,
                             device)
    if cfg.scheme == "nocache":
        return ()
    raise ValueError(f"unknown scheme {cfg.scheme!r}")


def init_carry(cfg: RackConfig, server_cfg: ServerConfig,
               client_cfg: cl.ClientConfig, num_keys: int,
               offered_rps: float, write_ratio: float, draws,
               device) -> SimCarry:
    if cfg.fetch_lanes % cfg.subrounds:
        raise ValueError(f"fetch_lanes ({cfg.fetch_lanes}) must be a "
                         f"multiple of subrounds ({cfg.subrounds})")
    reply_w, reply_pad = _reply_width(cfg, server_cfg)
    f32 = lambda v: torch.tensor(v, dtype=F32, device=device)
    return SimCarry(
        policy=init_policy(cfg, device),
        servers=init_servers(server_cfg, num_keys, device),
        clients=cl.init_clients(client_cfg, device),
        pending=interleave(empty_batch(reply_w + reply_pad, cfg.value_pad,
                                       device), cfg.subrounds),
        fetch=interleave(empty_batch(cfg.fetch_lanes, cfg.value_pad, device),
                         cfg.subrounds),
        draws=draws,
        now=f32(0.0),
        offered=f32(offered_rps * cfg.window_us * 1e-6),
        write_ratio=f32(write_ratio),
    )


def build_fetch_batch(cfg: RackConfig, vlen_table: torch.Tensor,
                      fetches: list[tuple[int, int]]) -> PacketBatch:
    """Controller F-REQs as a subround-major fetch batch (paper §3.8)."""
    dev = vlen_table.device
    fb = empty_batch(cfg.fetch_lanes, cfg.value_pad, dev)
    n = min(len(fetches), cfg.fetch_lanes)
    if n:
        kj = torch.tensor([k for k, _ in fetches[:n]], dtype=I32, device=dev)
        put = lambda a, v: torch.cat([torch.as_tensor(v, device=dev)
                                      .to(a.dtype).expand((n,) + a.shape[1:]),
                                      a[n:]])
        fb = fb._replace(
            op=put(fb.op, OP_F_REQ), kidx=put(fb.kidx, kj),
            hkey=put(fb.hkey, hash128_u32(kj)),
            vlen=put(fb.vlen, vlen_table[kj.long()]),
            server=put(fb.server, server_of_key(kj, cfg.num_servers)),
            valid=put(fb.valid, True),
        )
    return interleave(fb, cfg.subrounds)


def traced_fetch_batch(cfg: RackConfig, vlen_table: torch.Tensor,
                       fetch_kidx: torch.Tensor, fetch_valid: torch.Tensor,
                       ) -> PacketBatch:
    """Device twin of :func:`build_fetch_batch` for the F-REQ lanes of a
    :class:`~repro_torch.core.controller.TracedUpdate`; lanes beyond
    ``fetch_lanes`` drop, as the host path truncates its list."""
    w = cfg.fetch_lanes
    n = fetch_kidx.shape[0]
    dev = fetch_kidx.device
    if n < w:
        fetch_kidx = torch.cat([fetch_kidx, torch.full((w - n,), -1,
                                                       dtype=I32, device=dev)])
        fetch_valid = torch.cat([fetch_valid, torch.zeros(
            w - n, dtype=torch.bool, device=dev)])
    else:
        fetch_kidx, fetch_valid = fetch_kidx[:w], fetch_valid[:w]
    safe_k = torch.where(fetch_valid, fetch_kidx, 0)
    fb = empty_batch(w, cfg.value_pad, dev)
    fb = fb._replace(
        op=torch.where(fetch_valid, OP_F_REQ, fb.op),
        kidx=torch.where(fetch_valid, fetch_kidx, fb.kidx),
        hkey=torch.where(fetch_valid[:, None], hash128_u32(safe_k), fb.hkey),
        vlen=torch.where(fetch_valid, vlen_table[safe_k.long()], fb.vlen),
        server=torch.where(fetch_valid,
                           server_of_key(safe_k, cfg.num_servers), fb.server),
        valid=fetch_valid,
    )
    return interleave(fb, cfg.subrounds)


def controller_window_apply(cfg: RackConfig, ctrl_cfg: ControllerConfig,
                            wl: WorkloadArrays, carry: SimCarry,
                            active_size: torch.Tensor):
    """One control-plane period boundary on the device (orbitcache).

    Pulls the servers' top-k reports (resetting their trackers), runs
    :func:`~repro_torch.core.controller.controller_step` over the switch's
    period counters and queues the F-REQs for the next window.  Returns
    ``(carry', active', TracedUpdate, (top_kidx, top_est))``.
    """
    servers, top_k, top_e = server_reports_traced(carry.servers,
                                                  ctrl_cfg.k_report)
    sw = carry.policy
    sw2, active2, upd = controller_step(
        sw, top_k.reshape(-1), top_e.reshape(-1), sw.counters.overflow,
        sw.counters.cached_reqs, active_size, ctrl_cfg)
    fetch = traced_fetch_batch(cfg, wl.vlen, upd.fetch_kidx, upd.fetch_valid)
    return (carry._replace(policy=sw2, servers=servers, fetch=fetch),
            active2, upd, (top_k, top_e))


def generate_requests(cfg: RackConfig, client_cfg: cl.ClientConfig,
                      wl: WorkloadArrays, carry: SimCarry):
    """Draw this window's open-loop client batch: ``(clients', reqs)``."""
    return cl.generate(carry.clients, client_cfg, carry.draws, wl.cdf,
                       wl.perm, wl.vlen, carry.offered, carry.write_ratio,
                       cfg.num_servers, carry.now)


def generate_ingress(cfg: RackConfig, client_cfg: cl.ClientConfig,
                     wl: WorkloadArrays, carry: SimCarry):
    """Draw the client batch and assemble the switch ingress (client
    requests + pending server replies + controller F-REQs, concatenated
    along the lane axis).  Returns ``(clients', reqs, sub)``."""
    clients, reqs = generate_requests(cfg, client_cfg, wl, carry)
    sub = PacketBatch(*(torch.cat(xs, dim=1)
                        for xs in zip(reqs, carry.pending, carry.fetch)))
    return clients, reqs, sub


def window_step(cfg: RackConfig, server_cfg: ServerConfig,
                client_cfg: cl.ClientConfig, key_size: int,
                wl: WorkloadArrays, carry: SimCarry,
                ) -> tuple[SimCarry, WindowMetrics]:
    clients, reqs, sub = generate_ingress(cfg, client_cfg, wl, carry)
    return process_window(cfg, server_cfg, client_cfg, key_size, carry,
                          clients, reqs, sub)


def process_window(cfg: RackConfig, server_cfg: ServerConfig,
                   client_cfg: cl.ClientConfig, key_size: int,
                   carry: SimCarry, clients: cl.ClientState,
                   reqs: PacketBatch, sub: PacketBatch,
                   ) -> tuple[SimCarry, WindowMetrics]:
    """Run one window over the subround-major ingress ``sub``."""
    c = cfg
    dev = sub.op.device
    f32 = lambda v: device_const(v, F32, dev)
    pad_to = sub.op.shape[0] * sub.op.shape[1]
    window = f32(c.window_us)
    isum = lambda x: torch.sum(x, dtype=I32)
    zero = lambda: torch.zeros((), dtype=I32, device=dev)
    switch_reply = None       # lanes the switch answered itself (NetCache)

    if c.scheme == "orbitcache":
        policy, outs, intervals = pipeline.window_pipeline(
            carry.policy, sub, recirc_gbps=c.recirc_gbps,
            window_us=c.window_us, subrounds=c.subrounds,
            max_serves=c.max_serves, key_size=key_size)
        routes, flags, grids, stats = outs.route, outs.flag, outs.grid, \
            outs.stats
        # serve time = now + (r + 0.5) * window / R + (order + 1) * interval,
        # with window / R folded as window * (1 / R), as XLA compiles the
        # reference (exact for R a power of two)
        r_idx = torch.arange(c.subrounds, dtype=F32, device=dev)[:, None, None]
        k_sub = np.float32(c.window_us) * (np.float32(1.0)
                                           / np.float32(c.subrounds))
        serve_time = ((carry.now + (r_idx + f32(0.5)) * f32(k_sub))
                      + (grids.order.to(F32) + f32(1.0))
                      * intervals[:, None, None])
        j = c.max_serves
        clients = cl.account_switch_served(
            clients, client_cfg, grids.served.reshape(-1, j),
            grids.req_kidx.reshape(-1, j), grids.ts.reshape(-1, j),
            grids.kidx.reshape(-1), serve_time.reshape(-1, j))
        hits, installs = isum(stats.n_hit), isum(stats.n_install)
        overflow = isum(stats.n_overflow) + isum(stats.n_invalid_fwd)
        crn, rx_sw = isum(stats.n_crn), isum(stats.n_served)
    elif c.scheme == "netcache":
        policy, ys = carry.policy, []
        for r in range(c.subrounds):          # the reference's lax.scan
            policy, *y = netcache_step(policy,
                                       PacketBatch(*(a[r] for a in sub)))
            ys.append(y)
        routes, flags, sreps, n_hits = (torch.stack(x) for x in zip(*ys))
        switch_reply = sreps.reshape(-1)
        hits = isum(n_hits)
        overflow, installs, crn = zero(), zero(), zero()
        # every switch-served lane takes the switch pipeline's latency
        lat = (torch.full((pad_to,), 1.0, dtype=F32, device=dev)
               + f32(client_cfg.base_rtt_us))
        bucket = torch.where(switch_reply, cl.lat_bucket(lat), cl.LAT_BUCKETS)
        rx_sw = isum(switch_reply)
        clients = clients._replace(
            hist_switch=sat_add(clients.hist_switch,
                                cl._bucket_counts(bucket)),
            rx_switch=sat_add(clients.rx_switch, rx_sw))
    else:  # nocache
        policy, ys = carry.policy, []
        for r in range(c.subrounds):
            policy, *y = nocache_step(policy,
                                      PacketBatch(*(a[r] for a in sub)))
            ys.append(y)
        routes, flags = (torch.stack(x) for x in zip(*ys))
        hits, overflow, installs, crn, rx_sw = (zero() for _ in range(5))

    route_flat = routes.reshape(-1)
    flag_flat = flags.reshape(-1)
    ing_flat = PacketBatch(*(a.reshape((pad_to,) + a.shape[2:]) for a in sub))

    to_server = (route_flat == ROUTE_SERVER) & ing_flat.valid
    servers, sout = server_step(carry.servers, server_cfg, ing_flat,
                                to_server, flag_flat, carry.now)

    to_client = (route_flat == ROUTE_CLIENT) & ing_flat.valid
    if switch_reply is not None:
        to_client = to_client & ~switch_reply
    rx_srv_before = clients.rx_server
    clients = cl.account_server_replies(clients, client_cfg, ing_flat,
                                        to_client, carry.now + window)
    rx_srv = clients.rx_server - rx_srv_before

    reply_w, reply_pad = _reply_width(cfg, server_cfg)
    rep = sout.replies
    if reply_pad:
        pad_b = empty_batch(reply_pad, c.value_pad, dev)
        rep = PacketBatch(*(torch.cat([a, p]) for a, p in zip(rep, pad_b)))

    metrics = WindowMetrics(
        tx=isum(reqs.valid & (reqs.op != OP_NONE)),
        rx_switch=rx_sw, rx_server=rx_srv,
        served=sout.served_now, dropped=sout.dropped_now,
        backlog=sout.backlog, hits=hits, overflow=overflow,
        installs=installs, crn=crn, mismatches=clients.mismatches,
        fwd=isum(to_server),
    )
    new_carry = SimCarry(
        policy=policy, servers=servers, clients=clients,
        pending=interleave(rep, c.subrounds),
        fetch=interleave(empty_batch(c.fetch_lanes, c.value_pad, dev),
                         c.subrounds),
        draws=carry.draws, now=carry.now + window, offered=carry.offered,
        write_ratio=carry.write_ratio,
    )
    return new_carry, metrics


def period_windows(controller_period_s: float | None,
                   window_us: float) -> int | None:
    """Control-plane period length in windows (None = no periodic
    controller), rounded as the reference rounds it."""
    if not controller_period_s:
        return None
    return max(1, int(round(controller_period_s / (window_us * 1e-6))))


def chunked_run(total_windows: int, chunk_windows: int,
                period_w: int | None, use_traced_controller: bool,
                run_periods_fn, run_windows_fn,
                on_period=None) -> list[dict[str, np.ndarray]]:
    """The chunk loop behind ``run()`` (the reference's rules).

    * ``period_w`` set: whole periods, the window count rounded to the
      nearest multiple of ``period_w`` (at least one period), in chunks of
      equally many periods (one per chunk when ``on_period`` needs its
      callback); ``run_periods_fn`` when the scheme has a controller,
      else plain window chunks on the period cadence;
    * no period: window chunks rounded to whole chunks.

    ``on_period`` receives the number of windows completed.  Returns the
    per-chunk trace dicts.
    """
    traces: list[dict[str, np.ndarray]] = []
    if period_w:
        total_periods = max(1, int(round(total_windows / period_w)))
        periods_per_chunk = (1 if on_period
                             else max(1, chunk_windows // period_w))
        while total_periods % periods_per_chunk:
            periods_per_chunk -= 1
        step = (run_periods_fn if use_traced_controller
                else (lambda n_p, pw: run_windows_fn(n_p * pw)))
        done_p = 0
        while done_p < total_periods:
            traces.append(step(periods_per_chunk, period_w))
            done_p += periods_per_chunk
            if on_period:
                on_period(done_p * period_w)
    else:
        total = max(chunk_windows,
                    (total_windows // chunk_windows) * chunk_windows)
        done = 0
        while done < total:
            n = min(chunk_windows, total - done)
            traces.append(run_windows_fn(n))
            done += n
    return traces


def tree_map(fn, tree):
    """``fn`` of every tensor leaf of a tree of (Named)tuples; other leaves
    (a draw source) as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        items = [tree_map(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    return tree


def _clone_tree(x):
    """A copy of every tensor leaf of a tree (other leaves shared)."""
    return tree_map(torch.clone, x)


def _copy_tree_(dst, src) -> None:
    """Copy every tensor leaf of ``src`` into the same leaf of ``dst``, in
    place, device to device; a leaf that already is its target is
    skipped."""
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
    elif isinstance(dst, tuple):
        for d, v in zip(dst, src, strict=True):
            _copy_tree_(d, v)


def tree_stack(trees):
    """Stack a list of equal trees along a new leading (point) axis; a leaf
    that is not a tensor (a draw source) is taken from the first tree."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, tuple):
        items = [tree_stack(list(xs)) for xs in zip(*trees)]
        return type(first)(*items) if hasattr(first, "_fields") \
            else tuple(items)
    return first


def tree_take(tree, i: int):
    """Point ``i`` of a stacked tree (other leaves as they are)."""
    return tree_map(lambda v: v[i], tree)


def _write_row_(bufs, row, idx: torch.Tensor):
    """``bufs[idx] = row`` for every tensor leaf of a tree, at a device
    index."""
    if isinstance(bufs, torch.Tensor):
        bufs.index_copy_(0, idx, row[None])
    else:
        for b, v in zip(bufs, row, strict=True):
            _write_row_(b, v, idx)


def _rows(tree, cap: int):
    """Zeroed ``[cap, ...]`` buffers shaped like the leaves of ``tree``."""
    return tree_map(lambda v: torch.zeros((cap,) + v.shape, dtype=v.dtype,
                                          device=v.device), tree)


class CompiledChunk:
    """The port's counterpart of the reference's compiled chunks,
    ``compiled_chunk`` and ``compiled_controller_chunk``: ``n`` windows,
    or ``n_periods`` control-plane periods, over buffers the chunk owns.

    One window is a plain function of those buffers (:meth:`window_body`):
    ``window_step`` on the chunk's carry, every leaf of the new carry
    copied back into it, the window's metrics written at a device index,
    the index advanced.  A period boundary is another
    (:meth:`period_body`: ``controller_window_apply``, the carry and
    ``active_size`` copied back, the ``TracedUpdate`` written at a period
    index).  With ``graphs`` each body is captured once as a CUDA graph and
    a chunk replays it; without, a chunk calls it (the CPU path, and the
    card's when the caller asks).  Inside a chunk the host neither reads
    nor copies anything.

    * Host changes between chunks are seen: at each chunk start the
      caller's carry and workload arrays are copied into the chunk's
      buffers, device to device, wherever they are not those buffers.
    * The chunk reuses the carry's memory (the reference donates it): the
      carry a chunk returns IS the chunk's buffers, and the next chunk
      overwrites them.  Clone it to keep it.
    * A graph is captured after one warm-up call of its body, whose effect
      (carry, draws, counters, launch counts) is undone, and again when
      its key changes: the kernel backend, the draw source, the controller
      config or a larger chunk than the buffers hold.  A capture that
      fails raises.
    * ``repro_torch.kernels.LAUNCHES`` (and ``CALLS``) count the kernels a
      graph captured (and the dispatcher calls that launched them) once
      per replay.
    """

    def __init__(self, cfg: RackConfig, server_cfg: ServerConfig,
                 client_cfg: cl.ClientConfig, key_size: int, device,
                 graphs: bool):
        self.cfg, self.server_cfg, self.client_cfg = cfg, server_cfg, \
            client_cfg
        self.key_size = key_size
        self.device = device
        self.graphs = graphs
        self.carry = self.wl = self.metrics = self.updates = None
        self.ctrl_cfg = None
        self.w_idx = torch.zeros(1, dtype=torch.int64, device=device)
        self.p_idx = torch.zeros(1, dtype=torch.int64, device=device)
        self.active = torch.zeros((), dtype=I32, device=device)
        self.w_cap = self.p_cap = 0
        self._graphs: dict[str, tuple] = {}   # name -> (key, graph, counts)
        self.capture_seconds = 0.0            # warm-ups and captures
        self.captures = 0
        self.graph_bytes: dict[str, int] = {}  # memory reserved by capture

    # -- one window and one period boundary of the chunk's carry ----------
    def step(self, wl: WorkloadArrays, carry: SimCarry,
             ) -> tuple[SimCarry, WindowMetrics]:
        return window_step(self.cfg, self.server_cfg, self.client_cfg,
                           self.key_size, wl, carry)

    def apply(self, wl: WorkloadArrays, carry: SimCarry,
              active: torch.Tensor):
        """``(carry', active', TracedUpdate)`` of a period boundary."""
        return controller_window_apply(self.cfg, self.ctrl_cfg, wl, carry,
                                       active)[:3]

    def set_active(self, active_size) -> None:
        self.active.fill_(active_size)

    # -- the bodies ---------------------------------------------------------
    def window_body(self) -> None:
        new, m = self.step(self.wl, self.carry)
        _copy_tree_(self.carry, new)
        if self.metrics is None:
            self.metrics = _rows(m, self.w_cap)
        _write_row_(self.metrics, m, self.w_idx)
        self.w_idx += 1

    def period_body(self) -> None:
        new, act, upd = self.apply(self.wl, self.carry, self.active)
        _copy_tree_(self.carry, new)
        _copy_tree_(self.active, act)
        if self.updates is None:
            self.updates = _rows(upd, self.p_cap)
        _write_row_(self.updates, upd, self.p_idx)
        self.p_idx += 1

    # -- chunks -------------------------------------------------------------
    def __call__(self, wl: WorkloadArrays, carry: SimCarry, n: int,
                 ) -> tuple[SimCarry, WindowMetrics]:
        """``n`` windows: ``(carry', metrics [n, ...])``, both the chunk's
        buffers."""
        self._start(wl, carry, n, 0)
        self._run("window", self.window_body, n)
        return self.carry, tree_map(lambda b: b[:n], self.metrics)

    def controller_chunk(self, wl: WorkloadArrays, carry: SimCarry,
                         active_size: int, ctrl_cfg: ControllerConfig,
                         n_periods: int, period_w: int):
        """``n_periods`` periods of ``period_w`` windows, each followed by
        the cache update: ``(carry', active_size' int32[], metrics
        [n_periods * period_w, ...], TracedUpdate [n_periods, ...])``."""
        if ctrl_cfg != self.ctrl_cfg:
            self._graphs.pop("period", None)
            self.ctrl_cfg = ctrl_cfg
        self._start(wl, carry, n_periods * period_w, n_periods)
        self.set_active(active_size)
        for _ in range(n_periods):
            self._run("window", self.window_body, period_w)
            self._run("period", self.period_body, 1)
        n = n_periods * period_w
        return (self.carry, self.active,
                tree_map(lambda b: b[:n], self.metrics),
                tree_map(lambda b: b[:n_periods], self.updates))

    def _start(self, wl, carry, n_windows: int, n_periods: int) -> None:
        if n_windows < 1:
            raise ValueError(f"a chunk runs at least one window, not "
                             f"{n_windows}")
        if self.graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not "
                             f"{self.device}")
        carry.draws.reserve(n_windows)
        if self.carry is None:
            self.carry = _clone_tree(carry)
        else:
            _copy_tree_(self.carry, carry)
            self.carry = self.carry._replace(draws=carry.draws)
        if self.wl is None:
            self.wl = _clone_tree(wl)
        else:
            _copy_tree_(self.wl, wl)
        if n_windows > self.w_cap:
            self.w_cap, self.metrics = n_windows, None
            self._graphs.pop("window", None)
        if n_periods > self.p_cap:
            self.p_cap, self.updates = n_periods, None
            self._graphs.pop("period", None)
        self.w_idx.zero_()
        self.p_idx.zero_()

    def _run(self, name: str, body, n: int) -> None:
        if not self.graphs:
            for _ in range(n):
                body()
            return
        key = (kn.kernel_backend(self.device), self.carry.draws)
        got = self._graphs.get(name)
        if got is None or got[0] != key:    # draw sources compare by id
            got = self._graphs[name] = (key, *self._capture(name, body))
        _, graph, counts = got
        for _ in range(n):
            graph.replay()
        for total, per_replay in zip((kn.LAUNCHES, kn.CALLS), counts):
            for k, v in per_replay.items():
                total[k] += v * n

    def _capture(self, name: str, body):
        """Warm up ``body`` once and undo it, then capture it: ``(graph,
        (kernel launches, dispatcher calls) per replay)``."""
        t0 = time.perf_counter()
        draws = self.carry.draws
        saved = (_clone_tree(self.carry), draws.get_state(),
                 _clone_tree(self.active), self.w_idx.clone(),
                 self.p_idx.clone(), dict(kn.LAUNCHES), dict(kn.CALLS))
        body()
        _copy_tree_((self.carry, self.active, self.w_idx, self.p_idx),
                    (saved[0], *saved[2:5]))
        draws.set_state(saved[1])
        graph = torch.cuda.CUDAGraph()
        if name == "window":
            for gen in draws.generators():
                graph.register_generator_state(gen)
        before = (dict(kn.LAUNCHES), dict(kn.CALLS))
        with torch.cuda.graph(graph):
            reserved = torch.cuda.memory_reserved(self.device)
            body()
        counts = tuple({k: now[k] - b[k] for k in b}
                       for now, b in zip((kn.LAUNCHES, kn.CALLS), before))
        kn.LAUNCHES.update(saved[5])
        kn.CALLS.update(saved[6])
        self.graph_bytes[name] = (torch.cuda.memory_reserved(self.device)
                                  - reserved)
        self.capture_seconds += time.perf_counter() - t0
        self.captures += 1
        return graph, counts


def chunk_graphs(device: torch.device, graphs: bool | None) -> bool:
    """Whether a chunk on ``device`` replays CUDA graphs: by default on a
    CUDA device; asking for them elsewhere raises."""
    if graphs is None:
        graphs = device.type == "cuda"
    if graphs and device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
    return graphs


def compiled_chunk(cfg: RackConfig, server_cfg: ServerConfig,
                   client_cfg: cl.ClientConfig, key_size: int, device,
                   graphs: bool | None = None) -> CompiledChunk:
    """A simulator's chunk (:class:`CompiledChunk`), graphed as
    :func:`chunk_graphs` says."""
    device = torch.device(device)
    return CompiledChunk(cfg, server_cfg, client_cfg, key_size, device,
                         chunk_graphs(device, graphs))


@dataclass
class SimResult:
    """Host-side aggregation of a run."""
    window_us: float
    traces: dict[str, np.ndarray] = field(default_factory=dict)
    hist_switch: np.ndarray | None = None
    hist_server: np.ndarray | None = None
    info: dict = field(default_factory=dict)

    def throughput_rps(self, burn_frac: float = 0.25) -> float:
        rx = self.traces["rx_switch"] + self.traces["rx_server"]
        n = len(rx)
        b = int(n * burn_frac)
        return float(rx[b:].sum() / ((n - b) * self.window_us * 1e-6))

    def offered_rps(self, burn_frac: float = 0.25) -> float:
        tx = self.traces["tx"]
        n = len(tx)
        b = int(n * burn_frac)
        return float(tx[b:].sum() / ((n - b) * self.window_us * 1e-6))

    def per_server_rps(self, burn_frac: float = 0.25) -> np.ndarray:
        s = self.traces["served"]
        n = s.shape[0]
        b = int(n * burn_frac)
        return s[b:].sum(axis=0) / ((n - b) * self.window_us * 1e-6)

    def balancing_efficiency(self, burn_frac: float = 0.25) -> float:
        """Paper Fig. 13b: min server throughput / max server throughput."""
        rps = self.per_server_rps(burn_frac)
        return float(rps.min() / max(rps.max(), 1e-9))

    def max_server_drop_frac(self, burn_frac: float = 0.25) -> float:
        b = int(self.traces["served"].shape[0] * burn_frac)
        served = self.traces["served"][b:].sum(axis=0)
        dropped = self.traces["dropped"][b:].sum(axis=0)
        denom = np.maximum(served + dropped, 1)
        return float((dropped / denom).max())

    def overflow_ratio(self, burn_frac: float = 0.25) -> float:
        n = len(self.traces["hits"])
        b = int(n * burn_frac)
        ov = self.traces["overflow"][b:].sum()
        hits = self.traces["hits"][b:].sum()
        return float(ov / max(ov + hits, 1))

    def latency_percentile(self, q: float, which: str = "all") -> float:
        edges = np.asarray(cl.bucket_edges_us())
        if which == "switch":
            h = self.hist_switch
        elif which == "server":
            h = self.hist_server
        else:
            h = self.hist_switch + self.hist_server
        total = h.sum()
        if total == 0:
            return float("nan")
        cum = np.cumsum(h) / total
        i = int(np.searchsorted(cum, q))
        return float(edges[min(i + 1, len(edges) - 1)])


class RackSimulator:
    """One storage rack under a switch scheme (``cfg.scheme``).

    ``device`` defaults to the CUDA card; ``draws`` defaults to a
    :class:`~repro_torch.kvstore.client.TorchDraws` seeded from
    ``cfg.seed``.  On the card a chunk replays CUDA graphs unless
    ``graphs=False`` (:class:`CompiledChunk`).
    """

    def __init__(self, cfg: RackConfig, wl: Workload, device=None,
                 draws=None, graphs: bool | None = None):
        self.cfg = cfg
        self.wl = wl
        self.device = resolve_device(device)
        if wl.device != self.device:
            raise ValueError(f"workload lives on {wl.device}, the simulator "
                             f"on {self.device}")
        self.server_cfg = make_server_config(cfg)
        self.client_cfg = make_client_config(cfg)
        self.key_size = wl.cfg.key_size
        self.controller = CacheController(ControllerConfig(
            active_size=cfg.cache_entries, max_size=cfg.cache_entries))
        if draws is None:
            draws = cl.TorchDraws(cfg.seed, self.device)
        self.carry = init_carry(
            cfg, self.server_cfg, self.client_cfg, wl.cfg.num_keys,
            wl.cfg.offered_rps, wl.cfg.write_ratio, draws, self.device)
        self.chunk = compiled_chunk(cfg, self.server_cfg, self.client_cfg,
                                    self.key_size, self.device, graphs)

    def set_offered(self, rps: float) -> None:
        self.carry = self.carry._replace(offered=torch.tensor(
            rps * self.cfg.window_us * 1e-6, dtype=F32, device=self.device))

    def set_write_ratio(self, r: float) -> None:
        self.carry = self.carry._replace(write_ratio=torch.tensor(
            r, dtype=F32, device=self.device))

    def reset_stats(self) -> None:
        """Zero client histograms/counters (per-phase measurements)."""
        old = self.carry.clients
        self.carry = self.carry._replace(
            clients=cl.init_clients(self.client_cfg, self.device)._replace(
                next_seq=old.next_seq, crn_kidx=old.crn_kidx,
                crn_n=old.crn_n))

    def preload(self, keys: np.ndarray) -> None:
        """Install the hot set before measuring (paper §5.1).

        OrbitCache: the controller installs the keys, then 16 windows
        carry the F-REQs to the servers and the F-REPs back.  NetCache:
        the cacheable keys go straight into the table (``_installed``
        counts them).  NoCache: nothing to do."""
        c = self.cfg
        if c.scheme == "orbitcache":
            sw, fetches = self.controller.preload(self.carry.policy, keys)
            self.carry = self.carry._replace(policy=sw)
            self.inject_fetches(fetches)
            self.run_windows(16)
        elif c.scheme == "netcache":
            st, n = netcache_install(
                self.carry.policy, keys, self.wl.vlen_np[keys],
                key_size=self.wl.cfg.key_size,
                value_limit=c.netcache_value_limit)
            self.carry = self.carry._replace(policy=st)
            self._installed = n

    def inject_fetches(self, fetches: list[tuple[int, int]]) -> None:
        """Queue controller F-REQs for the next window (paper §3.8)."""
        self.carry = self.carry._replace(
            fetch=build_fetch_batch(self.cfg, self.wl.vlen, fetches))

    def run_windows(self, n: int) -> dict[str, np.ndarray]:
        """Step ``n`` windows as one chunk; returns the per-window metrics
        as numpy arrays with the reference's dtypes.  ``self.carry`` then
        is the chunk's buffers (see :class:`CompiledChunk`)."""
        self.carry, m = self.chunk(self.wl.arrays, self.carry, n)
        return to_numpy(m)._asdict()

    def run_periods(self, n_periods: int,
                    period_w: int) -> dict[str, np.ndarray]:
        """Advance ``n_periods`` control-plane periods of ``period_w``
        windows each, the cache update on the device after each period.
        The host reads ``active_size`` and the period updates
        (``_last_update``, stacked per period) once, at the end."""
        self.carry, act, m, upds = self.chunk.controller_chunk(
            self.wl.arrays, self.carry, self.controller.active_size,
            self.controller.cfg, n_periods, period_w)
        self.controller.active_size = int(act)
        self._last_update = to_numpy(upds)
        return to_numpy(m)._asdict()

    def run(self, sim_seconds: float, chunk_windows: int = 256,
            controller_period_s: float | None = None,
            on_period: Any = None) -> SimResult:
        """Run the rack for ``sim_seconds`` of simulated time.

        With ``controller_period_s`` the run is whole periods, the cache
        updates on the device (:meth:`run_periods`);
        ``on_period(sim, windows_done)`` fires after every period."""
        c = self.cfg
        total_windows = int(round(sim_seconds / (c.window_us * 1e-6)))
        period_w = period_windows(controller_period_s, c.window_us)
        traces = chunked_run(
            total_windows, chunk_windows, period_w,
            c.scheme == "orbitcache", self.run_periods, self.run_windows,
            on_period=(lambda w: on_period(self, w)) if on_period else None)
        merged = {k: np.concatenate([t[k] for t in traces], axis=0)
                  for k in traces[0]}
        cs = self.carry.clients
        return SimResult(
            window_us=c.window_us, traces=merged,
            hist_switch=to_numpy(cs.hist_switch, "hist_switch"),
            hist_server=to_numpy(cs.hist_server, "hist_server"),
            info=dict(scheme=c.scheme,
                      active_size=self.controller.active_size))

    def _control_plane_update(self) -> None:
        """Host-side cache update (switch counters + server top-k reports,
        §3.8): the oracle form of :func:`controller_window_apply`."""
        if self.cfg.scheme != "orbitcache":
            return
        servers, reports = server_reports(self.carry.servers,
                                          self.controller.cfg.k_report)
        sw = self.carry.policy
        sw2, info = self.controller.update(
            sw, reports, int(sw.counters.overflow),
            int(sw.counters.cached_reqs))
        self.carry = self.carry._replace(policy=sw2, servers=servers)
        self.inject_fetches(info.fetches)
        self._last_update = info
