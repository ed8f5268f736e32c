"""Discrete-time rack simulator (port of ``repro.kvstore.simulator``):
OrbitCache, NetCache and NoCache.

Time advances in windows (default 100 µs).  Each window the clients draw
an open-loop Poisson batch, the switch runs the fused pipeline over the
window's ``subrounds`` (one subround kernel launch each), the storage
servers drain their FIFOs, the clients account the replies, and the
servers' replies become next window's switch ingress.  Every ingress
source is kept subround-major ``[R, L]``.

The reference steps these windows one by one (:mod:`..rack`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import precision
from ..baselines.netcache import init_netcache, netcache_step
from ..baselines.nocache import nocache_step
from ..core import pipeline
from ..core.controller import ControllerConfig, controller_step
from ..core.hashing import hash128_u32, server_of_key
from ..core.types import (
    OP_F_REQ, OP_NONE, ROUTE_CLIENT, ROUTE_SERVER, PacketBatch, device_const,
    empty_batch, init_switch_state, sat_add,
)

from . import client as cl
from .server import (
    ServerConfig, ServerState, init_servers, server_reports_traced,
    server_step,
)
from .workload import WorkloadArrays

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
        lo = precision.site
        serve_time = ((lo(carry.now) + (lo(r_idx) + lo(f32(0.5)))
                       * lo(f32(k_sub)))
                      + (lo(grids.order.to(F32)) + lo(f32(1.0)))
                      * lo(intervals[:, None, None])).to(F32)
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
        draws=carry.draws,
        now=(precision.site(carry.now) + precision.site(window)).to(F32),
        offered=carry.offered,
        write_ratio=carry.write_ratio,
    )
    return new_carry, metrics


