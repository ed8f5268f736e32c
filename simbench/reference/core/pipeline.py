"""The fused switch pipeline: one kernel call per subround
(port of ``repro.core.pipeline``).

:func:`subround_pipeline` runs one ingress batch through the fused
``kernels.subround`` op and reduces its outputs into routes, stats and
counters; :func:`window_pipeline` loops it over a window's subrounds and
then installs the window's value bytes once (:func:`install_window_values`).

The recirculation budget is a float32 expression that feeds an integer
cast, so it follows the reference's float32 operations as XLA compiles
them (:func:`recirc_budget`), and every operand of a division is a float32
tensor on the data's device: ``scalar / tensor`` rounds twice in PyTorch,
and on CUDA ``tensor / cpu_scalar`` becomes a multiply by the reciprocal.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels as kn
from .. import precision

from .orbit import ServeGrid
from .types import (
    OP_CRN_REQ, OP_F_REP, OP_F_REQ, OP_R_REP, OP_R_REQ, OP_W_REP, OP_W_REQ,
    ROUTE_CLIENT, ROUTE_DROP, ROUTE_SERVER,
    Counters, LookupTable, OrbitBuffer, OrbitMeta, PacketBatch, RequestTable,
    StateTable, SwitchState, device_const, sat_add,
)

HDR_BYTES = 62
I32, F32 = torch.int32, torch.float32


class StepStats(NamedTuple):
    n_r_req: torch.Tensor
    n_hit: torch.Tensor
    n_enq: torch.Tensor
    n_overflow: torch.Tensor
    n_invalid_fwd: torch.Tensor
    n_w_req: torch.Tensor
    n_w_cached: torch.Tensor
    n_install: torch.Tensor
    n_served: torch.Tensor
    bytes_served: torch.Tensor  # int64 (the reference's uint32)
    n_crn: torch.Tensor
    n_fwd: torch.Tensor


class PipelineCarry(NamedTuple):
    """SwitchState minus the orbit value bytes."""

    lookup: LookupTable
    state: StateTable
    reqtab: RequestTable
    orbit: OrbitMeta
    counters: Counters


class SubroundOut(NamedTuple):
    route: torch.Tensor
    flag: torch.Tensor
    grid: ServeGrid
    stats: StepStats
    val_writer: torch.Tensor   # int32[C*F] winning ingress lane per line
    val_written: torch.Tensor  # bool[C*F]


def strip_val(sw: SwitchState) -> tuple[PipelineCarry, torch.Tensor]:
    o = sw.orbit
    meta = OrbitMeta(live=o.live, kidx=o.kidx, version=o.version,
                     vlen=o.vlen, frags=o.frags)
    return PipelineCarry(lookup=sw.lookup, state=sw.state, reqtab=sw.reqtab,
                         orbit=meta, counters=sw.counters), o.val


def with_val(carry: PipelineCarry, val: torch.Tensor) -> SwitchState:
    m = carry.orbit
    orbit = OrbitBuffer(live=m.live, kidx=m.kidx, version=m.version,
                        vlen=m.vlen, val=val, frags=m.frags)
    return SwitchState(lookup=carry.lookup, state=carry.state,
                       reqtab=carry.reqtab, orbit=orbit,
                       counters=carry.counters)


def _count(mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(mask, dtype=I32)


def subround_pipeline(carry: PipelineCarry, pkts: PacketBatch,
                      recirc_packets: torch.Tensor, max_serves: int,
                      ) -> tuple[PipelineCarry, SubroundOut]:
    """One fused ingress pass + orbit serving round (paper Fig. 4)."""
    op, valid = pkts.op, pkts.valid
    r_req = valid & (op == OP_R_REQ)
    w_req = valid & (op == OP_W_REQ)
    r_rep = valid & (op == OP_R_REP)
    w_rep = valid & (op == OP_W_REP)
    f_rep = valid & (op == OP_F_REP)
    f_req = valid & (op == OP_F_REQ)
    crn = valid & (op == OP_CRN_REQ)

    lk, st, rt_, orb = carry.lookup, carry.state, carry.reqtab, carry.orbit
    k = kn.subround(
        pkts.hkey, r_req.to(I32), w_req.to(I32),
        ((w_rep | f_rep) & (pkts.flag >= 1)).to(I32),
        torch.where(f_rep, pkts.seq, 0),   # F-REP: seq carries the fragment
        torch.clamp(pkts.flag, min=1),     # FLAG carries the fragment count
        pkts.kidx, pkts.vlen, pkts.client, pkts.seq, pkts.port, pkts.ts,
        lk.hkeys, lk.occupied.to(I32), st.valid.to(I32), st.version,
        rt_.client, rt_.seq, rt_.port, rt_.ts, rt_.acked, rt_.kidx,
        rt_.qlen, rt_.front, rt_.rear,
        orb.live.to(I32), orb.kidx, orb.version, orb.vlen, orb.frags,
        recirc_packets,
        queue_size=rt_.queue_size, max_frags=orb.max_frags,
        max_serves=max_serves,
    )

    hit = (k.hit > 0) & valid
    entry_valid = (k.vhit > 0) & valid
    accepted = k.accepted > 0
    overflow = k.overflow > 0
    r_hit = r_req & hit
    invalid_fwd = r_hit & ~entry_valid
    w_cached = w_req & hit
    install = (w_rep | f_rep) & hit & (pkts.flag >= 1)
    flag_out = torch.where(w_cached, 1, pkts.flag).to(I32)

    n_hit = _count(r_hit)
    n_overflow = _count(overflow)
    n_invalid_fwd = _count(invalid_fwd)

    ctr = carry.counters
    counters = Counters(
        popularity=sat_add(ctr.popularity, k.pop),
        hits=sat_add(ctr.hits, n_hit),
        overflow=sat_add(ctr.overflow, n_overflow + n_invalid_fwd),
        cached_reqs=sat_add(ctr.cached_reqs, n_hit),
    )
    carry3 = PipelineCarry(
        lookup=lk,
        state=StateTable(valid=k.st_valid > 0, version=k.st_version),
        reqtab=RequestTable(
            client=k.rt_client, seq=k.rt_seq, port=k.rt_port, ts=k.rt_ts,
            acked=k.rt_acked, kidx=k.rt_kidx,
            qlen=k.qlen, front=k.front, rear=k.rear),
        orbit=OrbitMeta(live=k.ob_live > 0, kidx=k.ob_kidx,
                        version=k.ob_version, vlen=k.ob_vlen,
                        frags=k.ob_frags),
        counters=counters,
    )

    served = k.served > 0
    grid = ServeGrid(
        served=served, client=k.g_client, seq=k.g_seq, port=k.g_port,
        ts=k.g_ts,
        order=torch.arange(max_serves, dtype=I32, device=served.device
                           )[None, :].expand(served.shape),
        req_kidx=k.g_kidx, kidx=k.line_kidx, vlen=k.line_vlen,
        version=k.line_version,
    )
    bytes_served = torch.sum(torch.where(served, grid.vlen[:, None], 0),
                             dtype=I32).to(torch.int64) & 0xFFFFFFFF

    to_server = (r_req & ~hit) | overflow | invalid_fwd | w_req | crn | f_req
    to_client = r_rep | w_rep
    route = torch.full_like(pkts.op, ROUTE_DROP)
    route = torch.where(to_server & valid, ROUTE_SERVER, route)
    route = torch.where(to_client & valid, ROUTE_CLIENT, route).to(I32)

    stats = StepStats(
        n_r_req=_count(r_req), n_hit=n_hit, n_enq=_count(accepted),
        n_overflow=n_overflow, n_invalid_fwd=n_invalid_fwd,
        n_w_req=_count(w_req), n_w_cached=_count(w_cached),
        n_install=_count(install), n_served=_count(served),
        bytes_served=bytes_served, n_crn=_count(crn),
        n_fwd=_count(to_server & valid),
    )
    return carry3, SubroundOut(route=route, flag=flag_out, grid=grid,
                               stats=stats, val_writer=k.val_writer,
                               val_written=k.val_written > 0)


def install_window_values(val: torch.Tensor, batch_val: torch.Tensor,
                          val_writer: torch.Tensor, val_written: torch.Tensor,
                          ) -> torch.Tensor:
    """Apply a window's orbit value installs in one pass.

    Per line the winner is the LAST subround that installed it (the kernel
    already picked the last lane within a subround).
    ``val`` uint8[C*F, pad]; ``batch_val`` uint8[R, L, pad];
    ``val_writer`` int32[R, C*F]; ``val_written`` bool[R, C*F].
    """
    r = val_written.shape[0]
    rev = torch.flip(val_written, dims=(0,)).to(torch.uint8)
    r_star = r - 1 - torch.argmax(rev, dim=0)                    # [C*F]
    any_w = torch.any(val_written, dim=0)
    lane = torch.gather(val_writer, 0, r_star[None, :])[0].long()
    return torch.where(any_w[:, None], batch_val[r_star, lane], val)



def recirc_budget(live: torch.Tensor, vlen: torch.Tensor, *,
                  recirc_gbps: float, window_us: float, subrounds: int,
                  key_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(budget int32[...], interval_us float32[...]) of one subround, for
    lines along the last axis of ``live`` / ``vlen``.

    The port bandwidth divided by the mean live line size (header + key +
    value fragment).  The float32 operations are those the reference
    compiles to: XLA folds the constants of ``pipeline.py:355-362``, so the
    reference computes ``mean + (62 + key_size)``, ``pps * K`` with
    ``K = (window * 1e-6) * (1 / subrounds)`` and the interval as
    ``(nlive * mean_line) * ((1 / P) * 1e6)`` with ``P`` the port rate in
    packets of one byte.  Those constants are folded here in float32 the
    same way; the budget feeds the kernel's serve counts, so a one-ulp
    difference would spread into the switch state.
    """
    f32 = lambda v: device_const(v, F32, live.device)
    one = np.float32(1.0)
    port_rate = np.float32(recirc_gbps * 1e9 / 8.0)
    k_budget = ((np.float32(window_us) * np.float32(1e-6))
                * (one / np.float32(subrounds)))
    k_interval = (one / port_rate) * np.float32(1e6)
    nlive = torch.clamp(torch.sum(live, dim=-1, dtype=I32), min=1)
    lo = precision.site
    mean_line = (lo(torch.sum(torch.where(live, vlen, 0), dim=-1, dtype=I32
                              ).to(F32))
                 / lo(nlive.to(F32)) + lo(f32(HDR_BYTES + key_size)))
    pps = (lo(f32(port_rate)) / mean_line).to(F32)
    mean_line = mean_line.to(F32)
    budget = (pps * f32(k_budget)).to(I32)
    interval_us = (nlive.to(F32) * mean_line) * f32(k_interval)
    return budget, interval_us


def _stack(items):
    """Stack a list of equal NamedTuple trees along a new leading axis."""
    first = items[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack([getattr(x, n) for x in items])
                             for n in first._fields))
    return torch.stack(items)


def window_pipeline(sw: SwitchState, sub: PacketBatch, *, recirc_gbps: float,
                    window_us: float, subrounds: int, max_serves: int,
                    key_size: int,
                    ) -> tuple[SwitchState, SubroundOut, torch.Tensor]:
    """One window: the fused pass over each subround of the [R, L] ingress,
    then the value install.  Returns ``(sw', outs, intervals_us)`` with the
    subround axis leading in ``outs`` and ``intervals_us``."""
    carry, val = strip_val(sw)
    outs, intervals = [], []
    for r in range(sub.op.shape[0]):
        pk = PacketBatch(*(a[r] for a in sub))
        budget, interval_us = recirc_budget(
            carry.orbit.live, carry.orbit.vlen, recirc_gbps=recirc_gbps,
            window_us=window_us, subrounds=subrounds, key_size=key_size)
        carry, out = subround_pipeline(carry, pk, budget, max_serves)
        outs.append(out)
        intervals.append(interval_us)
    outs = _stack(outs)
    val = install_window_values(val, sub.val, outs.val_writer,
                                outs.val_written)
    return with_val(carry, val), outs, torch.stack(intervals)
