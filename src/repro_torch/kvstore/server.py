"""Emulated storage servers (port of ``repro.kvstore.server``).

Each server is a FIFO ring drained at ``cap_per_window`` requests per
window; arrivals beyond the queue depth drop.  Served requests become
replies (R-REQ -> R-REP, W-REQ -> W-REP, F-REQ -> F-REP, CRN-REQ -> R-REP),
``max_frags`` lanes each.  With ``track_popularity`` every server's
count-min tracker counts its accepted reads, all servers in one count-min
kernel launch per window.  The enqueue is one ``server_enqueue`` and the
replies' value bytes one ``reply_values`` kernel launch per window, for
all servers (and all points of a fleet).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import kernels as kn
from repro_torch.core.hashing import hash128_u32
from repro_torch.core.sketch import (
    PopularityTracker, init_tracker, report_and_reset, track_fused,
)
from repro_torch.core.types import (
    COUNTER_DTYPE, OP_CRN_REQ, OP_F_REP, OP_F_REQ, OP_R_REP, OP_R_REQ,
    OP_W_REP, OP_W_REQ, PacketBatch, resolve_device, sat_add,
)

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


RING_FIELDS = ("op", "kidx", "seq", "client", "port", "flag", "vlen", "ts")


class ServerStepOut(NamedTuple):
    replies: PacketBatch          # [n_srv * cap * F]
    served_now: torch.Tensor      # int32[n_srv]
    dropped_now: torch.Tensor     # int32[n_srv]
    backlog: torch.Tensor         # int32[n_srv]


def server_step(st: ServerState, cfg: ServerConfig, pkts: PacketBatch,
                to_server: torch.Tensor, flag_in: torch.Tensor,
                now: torch.Tensor, donate: bool = False,
                ) -> tuple[ServerState, ServerStepOut]:
    """Enqueue this window's arrivals, serve up to ``cap`` per server and
    emit the reply lanes.

    ``donate``: the caller owns ``st`` and gives it up (a chunk's own
    carry, as the reference donates its scan's), so the write versions are
    added into ``st.key_version`` in place; otherwise ``st`` is left as it
    was and the new table is a new tensor."""
    n, q, cap, f = (cfg.num_servers, cfg.queue_depth, cfg.cap_per_window,
                    cfg.max_frags)
    pad = cfg.value_pad
    dev = pkts.op.device
    ar = lambda m: torch.arange(m, dtype=I32, device=dev)

    # ---- enqueue arrivals: one kernel launch for all points ---------------
    rings, qlen, rear, _, dropped_now, accepted = kn.server_enqueue(
        pkts.server, to_server,
        (pkts.op, pkts.kidx, pkts.seq, pkts.client, pkts.port, flag_in,
         pkts.vlen, pkts.ts),
        tuple(getattr(st, k) for k in RING_FIELDS), st.qlen, st.rear)
    st = st._replace(**dict(zip(RING_FIELDS, rings)), qlen=qlen, rear=rear,
                     dropped=sat_add(st.dropped, dropped_now))

    # ---- popularity tracking on accepted reads (CMS + candidates) ----------
    if cfg.track_popularity:
        is_read = accepted & (pkts.op == OP_R_REQ)
        per_srv_mask = (pkts.server[None, :] == ar(n)[:, None]) \
            & is_read[None, :]                           # [n, B]
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

    # write versions bump before value generation (dropped lanes add 0);
    # a scatter-add, which vmap batches as one op (its index_add batching
    # rule adds point by point and stacks the whole table)
    w_mask = live & (s_op == OP_W_REQ)
    bump = (st.key_version.scatter_add_ if donate
            else st.key_version.scatter_add)
    kv = bump(
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
    frag_vlen = torch.clamp(s_vlen[:, :, None] - frag * pad, 0, pad)
    # each lane's value bytes (synth_value of its key and version under
    # frag_vlen and carries_val): one kernel launch for all points
    val = kn.reply_values(s_kidx, version, s_vlen, carries_val, f, pad)

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
        val=val,
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


def server_reports(st: ServerState, k: int):
    """Host-side: per-server top-k report + tracker reset (paper §3.8)."""
    st2, top_k, top_e = server_reports_traced(st, k)
    top_k, top_e = top_k.cpu().numpy(), top_e.cpu().numpy()
    return st2, [(top_k[s], top_e[s]) for s in range(top_k.shape[0])]
