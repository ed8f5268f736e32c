"""Emulated storage servers (port of ``repro.kvstore.server``).

Each server is a FIFO ring drained at ``cap_per_window`` requests per
window; arrivals beyond the queue depth drop.  Served requests become
replies (R-REQ -> R-REP, W-REQ -> W-REP, F-REQ -> F-REP, CRN-REQ -> R-REP),
``max_frags`` lanes each.  With ``track_popularity`` every server's
count-min tracker counts its accepted reads, all servers in one count-min
kernel launch per window.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.hashing import hash128_u32
from ..core.scatter_free import unique_writer
from ..core.sketch import (
    PopularityTracker, init_tracker, report_and_reset, track_fused,
)
from ..core.types import (
    COUNTER_DTYPE, OP_CRN_REQ, OP_F_REP, OP_F_REQ, OP_R_REP, OP_R_REQ,
    OP_W_REP, OP_W_REQ, PacketBatch, resolve_device, sat_add,
)

from .store import synth_value

I32 = torch.int32


class ServerConfig(NamedTuple):
    num_servers: int = 32
    queue_depth: int = 64
    cap_per_window: int = 10
    value_pad: int = 1438
    max_frags: int = 1
    cms_width: int = 2048
    k_candidates: int = 128
    track_popularity: bool = False


class ServerState(NamedTuple):
    op: torch.Tensor        # int32[n_srv, Q] FIFO rings ...
    kidx: torch.Tensor
    seq: torch.Tensor
    client: torch.Tensor
    port: torch.Tensor
    flag: torch.Tensor
    vlen: torch.Tensor
    ts: torch.Tensor        # float32[n_srv, Q]
    qlen: torch.Tensor      # int32[n_srv]
    front: torch.Tensor
    rear: torch.Tensor
    key_version: torch.Tensor  # int32[num_keys]
    tracker: PopularityTracker  # leading dim n_srv
    served: torch.Tensor    # int64[n_srv] (uint32 values)
    dropped: torch.Tensor   # int64[n_srv]


def init_servers(cfg: ServerConfig, num_keys: int, device=None) -> ServerState:
    n, q = cfg.num_servers, cfg.queue_depth
    d = resolve_device(device)
    zi = lambda *s: torch.zeros(s, dtype=I32, device=d)
    return ServerState(
        op=zi(n, q), kidx=zi(n, q), seq=zi(n, q), client=zi(n, q),
        port=zi(n, q), flag=zi(n, q), vlen=zi(n, q),
        ts=torch.zeros((n, q), dtype=torch.float32, device=d),
        qlen=zi(n), front=zi(n), rear=zi(n),
        key_version=zi(num_keys),
        tracker=init_tracker(cfg.cms_width, cfg.k_candidates, (n,), d),
        served=torch.zeros(n, dtype=COUNTER_DTYPE, device=d),
        dropped=torch.zeros(n, dtype=COUNTER_DTYPE, device=d),
    )


class ServerStepOut(NamedTuple):
    replies: PacketBatch          # [n_srv * cap * F]
    served_now: torch.Tensor      # int32[n_srv]
    dropped_now: torch.Tensor     # int32[n_srv]
    backlog: torch.Tensor         # int32[n_srv]


def server_step(st: ServerState, cfg: ServerConfig, pkts: PacketBatch,
                to_server: torch.Tensor, flag_in: torch.Tensor,
                now: torch.Tensor) -> tuple[ServerState, ServerStepOut]:
    """Enqueue this window's arrivals, serve up to ``cap`` per server and
    emit the reply lanes."""
    n, q, cap, f = (cfg.num_servers, cfg.queue_depth, cfg.cap_per_window,
                    cfg.max_frags)
    pad = cfg.value_pad
    dev = pkts.op.device
    ar = lambda m: torch.arange(m, dtype=I32, device=dev)

    # ---- enqueue arrivals ---------------------------------------------------
    srv = torch.where(to_server, pkts.server, 0).long()
    onehot = (srv[:, None] == ar(n)[None, :]) & to_server[:, None]
    oh = onehot.to(I32)
    prior = torch.cumsum(oh, dim=0, dtype=I32) - oh
    offset = torch.gather(prior, 1, srv[:, None])[:, 0]
    free = (q - st.qlen)[srv]
    accepted = to_server & (offset < free)
    dropped_now = torch.sum((to_server & ~accepted)[:, None] & onehot, dim=0,
                            dtype=I32)
    slot = (st.rear[srv] + offset) % q
    writer, written = unique_writer(srv * q + slot, accepted, n * q)
    put = lambda arr, val: torch.where(written, val[writer],
                                       arr.reshape(-1)).reshape(n, q)
    new_counts = torch.sum(onehot & accepted[:, None], dim=0, dtype=I32)
    st = st._replace(
        op=put(st.op, pkts.op), kidx=put(st.kidx, pkts.kidx),
        seq=put(st.seq, pkts.seq), client=put(st.client, pkts.client),
        port=put(st.port, pkts.port), flag=put(st.flag, flag_in),
        vlen=put(st.vlen, pkts.vlen), ts=put(st.ts, pkts.ts),
        qlen=st.qlen + new_counts, rear=(st.rear + new_counts) % q,
        dropped=sat_add(st.dropped, dropped_now),
    )

    # ---- popularity tracking on accepted reads (CMS + candidates) ----------
    if cfg.track_popularity:
        is_read = accepted & (pkts.op == OP_R_REQ)
        per_srv_mask = (onehot & is_read[:, None]).T     # [n, B]
        st = st._replace(tracker=track_fused(st.tracker, pkts.kidx,
                                             per_srv_mask))

    # ---- serve up to cap per server -----------------------------------------
    j = ar(cap)[None, :]
    n_serve = torch.clamp(st.qlen, max=cap)
    live = j < n_serve[:, None]
    slot_s = ((st.front[:, None] + j) % q).long()
    g = lambda arr: torch.gather(arr, 1, slot_s)
    s_op, s_kidx, s_seq = g(st.op), g(st.kidx), g(st.seq)
    s_client, s_flag = g(st.client), g(st.flag)
    s_vlen, s_ts = g(st.vlen), g(st.ts)

    # write versions bump before value generation (dropped lanes add 0)
    w_mask = live & (s_op == OP_W_REQ)
    kv = st.key_version.index_add(
        0, torch.where(w_mask, s_kidx, 0).reshape(-1).long(),
        w_mask.reshape(-1).to(I32))
    version = kv[s_kidx.long()]

    n_frags = torch.clamp(torch.div(s_vlen + pad - 1, pad,
                                    rounding_mode="floor"), 1, f)
    rep_op = torch.full_like(s_op, OP_R_REP)
    rep_op = torch.where(s_op == OP_W_REQ, OP_W_REP, rep_op)
    rep_op = torch.where(s_op == OP_F_REQ, OP_F_REP, rep_op).to(I32)
    cached_w = (s_op == OP_W_REQ) & (s_flag >= 1)
    carries_val = ((s_op == OP_R_REQ) | (s_op == OP_CRN_REQ)
                   | (s_op == OP_F_REQ) | cached_w)
    rep_flag = torch.where((s_op == OP_F_REQ) | cached_w, n_frags, 0).to(I32)

    # ---- emit [n, cap, F] reply lanes --------------------------------------
    frag = ar(f)[None, None, :]
    lane_valid = live[:, :, None] & (
        frag < torch.where(carries_val, n_frags, 1)[:, :, None])
    frag_off = frag * pad
    frag_vlen = torch.clamp(s_vlen[:, :, None] - frag_off, 0, pad)
    val = synth_value(s_kidx[:, :, None].expand(n, cap, f),
                      version[:, :, None].expand(n, cap, f), pad,
                      offset=frag_off.expand(n, cap, f))
    keep = ((torch.arange(pad, device=dev)[None, None, None, :]
             < frag_vlen[..., None]) & carries_val[:, :, None, None])
    val = torch.where(keep, val, 0).to(torch.uint8)

    def fl(x):  # [n, cap, F] -> [n*cap*F]
        return x.expand(n, cap, f).reshape(-1)

    flat_kidx = fl(s_kidx[:, :, None])
    flat_op = fl(rep_op[:, :, None])
    replies = PacketBatch(
        op=flat_op,
        seq=torch.where(flat_op == OP_F_REP, fl(frag), fl(s_seq[:, :, None])),
        hkey=hash128_u32(flat_kidx), flag=fl(rep_flag[:, :, None]),
        kidx=flat_kidx,
        vlen=torch.where(fl(carries_val[:, :, None]), fl(frag_vlen), 0
                         ).to(I32),
        client=fl(s_client[:, :, None]),
        port=fl(frag),   # reply lanes carry the fragment index in ``port``
        server=fl(ar(n)[:, None, None]),
        ts=fl(s_ts[:, :, None]), valid=fl(lane_valid),
        val=val.reshape(n * cap * f, pad),
    )

    st = st._replace(
        qlen=st.qlen - n_serve, front=(st.front + n_serve) % q,
        key_version=kv, served=sat_add(st.served, n_serve),
    )
    return st, ServerStepOut(replies=replies, served_now=n_serve,
                             dropped_now=dropped_now, backlog=st.qlen)


def server_reports_traced(st: ServerState, k: int,
                          ) -> tuple[ServerState, torch.Tensor, torch.Tensor]:
    """Per-server top-k report + tracker reset (paper §3.8), on the device.

    Returns ``(st', top_kidx int32[n_srv, k], top_est int32[n_srv, k])``.
    """
    fresh, top_k, top_e = report_and_reset(st.tracker, k)
    return st._replace(tracker=fresh), top_k, top_e


