"""The orbit: circulating cache packets (port of ``repro.core.orbit``,
paper §2.2, §3.5, §3.7).

A window gives every live orbit line a pass budget: the recirculation
port's packets divided among the live lines.  Each pass over an entry
with pending requests serves the front request, and by PRE cloning the
line keeps circulating, so a line serves up to ``min(qlen, passes)``
requests a window.  Stale lines (entry evicted, or version behind the
state table because a write invalidated it) are dropped before they touch
the request table (paper §3.7).  The fused ``kernels.subround`` pass runs
this round inside the kernel; :func:`orbit_pass` and the installs below
are the composed form it is held against.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import request_table as rt
from .scatter_free import last_writer, set_drop
from .types import OrbitBuffer, OrbitMeta, SwitchState

I32 = torch.int32


class ServeGrid(NamedTuple):
    """Requests served by orbit lines this pass: dense [C, J] grid."""

    served: torch.Tensor   # bool[C, J]
    client: torch.Tensor   # int32[C, J]
    seq: torch.Tensor      # int32[C, J]
    port: torch.Tensor     # int32[C, J]
    ts: torch.Tensor       # float32[C, J] request submit time
    order: torch.Tensor    # int32[C, J] serve order within window
    req_kidx: torch.Tensor # int32[C, J] key each request asked for
    kidx: torch.Tensor     # int32[C]  key carried by the serving line
    vlen: torch.Tensor     # int32[C]  total value bytes for the entry
    version: torch.Tensor  # int32[C]


def refresh_liveness(sw: SwitchState) -> OrbitBuffer:
    """Drop-stale rule: live &= occupied & valid & version-current."""
    orbit = sw.orbit
    ent = torch.arange(sw.lookup.occupied.shape[0], device=orbit.live.device
                       ).repeat_interleave(orbit.max_frags)
    ok = (sw.lookup.occupied[ent] & sw.state.valid[ent]
          & (orbit.version == sw.state.version[ent]) & orbit.live)
    return orbit._replace(live=ok)


def live_line_count(orbit: OrbitBuffer) -> torch.Tensor:
    return torch.sum(orbit.live, dtype=I32)


def pass_budget(orbit: OrbitBuffer, recirc_packets: torch.Tensor,
                ) -> torch.Tensor:
    """int32[C] serve budget of a window: ``recirc_packets`` divided evenly
    among the live lines; an entry serves only when all its fragments are
    live (§3.10: a request needs every fragment)."""
    c, f = orbit.frags.shape[0], orbit.max_frags
    n_live = torch.clamp(live_line_count(orbit), min=1)
    per_line = torch.div(recirc_packets, n_live, rounding_mode="floor")
    live_frags = torch.sum(orbit.live.reshape(c, f), dim=1, dtype=I32)
    return torch.where(live_frags >= orbit.frags, per_line, 0).to(I32)


def orbit_pass(sw: SwitchState, recirc_packets: torch.Tensor,
               max_serves: int) -> tuple[SwitchState, ServeGrid]:
    """One serving round: refresh liveness, serve pending requests, pop
    them."""
    orbit = refresh_liveness(sw)
    budget = pass_budget(orbit, recirc_packets)
    deq = rt.peek_front(sw.reqtab, budget, max_serves)
    reqtab = rt.pop(sw.reqtab, torch.sum(deq.served, dim=1, dtype=I32))

    c, f = orbit.frags.shape[0], orbit.max_frags
    first = torch.arange(c, device=orbit.live.device) * f
    grid = ServeGrid(
        served=deq.served, client=deq.client, seq=deq.seq, port=deq.port,
        ts=deq.ts,
        order=torch.arange(max_serves, dtype=I32, device=orbit.live.device
                           )[None, :].expand(deq.served.shape),
        req_kidx=deq.kidx,
        kidx=orbit.kidx[first],
        vlen=torch.sum(orbit.vlen.reshape(c, f), dim=1, dtype=I32),
        version=orbit.version[first],
    )
    return sw._replace(orbit=orbit, reqtab=reqtab), grid


def install_lines(orbit: OrbitBuffer, cidx: torch.Tensor, mask: torch.Tensor,
                  kidx: torch.Tensor, version: torch.Tensor,
                  vlen: torch.Tensor, val: torch.Tensor,
                  frag: torch.Tensor | None = None,
                  n_frags: torch.Tensor | None = None) -> OrbitBuffer:
    """Install fresh cache packets (W-REP / F-REP with FLAG, paper
    §3.3(d)): :func:`install_lines_meta`, then the value bytes ``val``
    uint8[B, value_pad] of each line's winning packet."""
    meta, writer, written = install_lines_meta(
        OrbitMeta(live=orbit.live, kidx=orbit.kidx, version=orbit.version,
                  vlen=orbit.vlen, frags=orbit.frags),
        cidx, mask, kidx, version, vlen, frag=frag, n_frags=n_frags)
    return OrbitBuffer(
        live=meta.live, kidx=meta.kidx, version=meta.version, vlen=meta.vlen,
        val=torch.where(written[:, None], val[writer], orbit.val),
        frags=meta.frags)


def install_lines_meta(orbit: OrbitMeta, cidx: torch.Tensor,
                       mask: torch.Tensor, kidx: torch.Tensor,
                       version: torch.Tensor, vlen: torch.Tensor,
                       frag: torch.Tensor | None = None,
                       n_frags: torch.Tensor | None = None,
                       ) -> tuple[OrbitMeta, torch.Tensor, torch.Tensor]:
    """Metadata half of an install: ``(meta', writer int32[C*F], written
    bool[C*F])``.  Per line the LAST packet installing it wins, as the
    reference's scatter order has it."""
    c, f = orbit.frags.shape[0], orbit.max_frags
    if frag is None:
        frag = torch.zeros_like(cidx)
    if n_frags is None:
        n_frags = torch.ones_like(cidx)
    line = cidx * f + torch.clamp(frag, 0, f - 1)
    writer, written = last_writer(line, mask, c * f)
    writer = writer.to(I32)
    ent_writer, ent_written = last_writer(cidx, mask & (frag == 0), c)

    def pick(arr, src):
        return torch.where(written, src[writer], arr)

    meta = OrbitMeta(
        live=orbit.live | written,
        kidx=pick(orbit.kidx, kidx),
        version=pick(orbit.version, version),
        vlen=pick(orbit.vlen, vlen),
        frags=torch.where(ent_written,
                          torch.clamp(n_frags, min=1)[ent_writer],
                          orbit.frags),
    )
    return meta, writer, written


def evict_lines(orbit: OrbitBuffer, cidx: torch.Tensor) -> OrbitBuffer:
    """Kill all fragment lines of the given entries (controller eviction).
    A negative ``cidx`` counts from the end, as in the reference."""
    f = orbit.max_frags
    lines = (cidx[:, None] * f
             + torch.arange(f, dtype=cidx.dtype, device=cidx.device)[None, :]
             ).reshape(-1)
    return orbit._replace(live=set_drop(orbit.live, lines, False))
