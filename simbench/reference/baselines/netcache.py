"""NetCache [21] baseline: hot items stored in switch memory (port of
``repro.baselines.netcache``, paper §2.1).

* the lookup is an exact-match table on the key, so keys are capped at
  16 bytes;
* values live across match-action stages, capped at ``value_limit``
  bytes (64 B in the paper's NetCache prototype);
* hits are answered by the switch; writes invalidate and go through to
  the server, and write or fetch replies refresh the stored value.

Items over either limit are uncacheable: :func:`netcache_install` refuses
them.  The table is a 2-probe direct-indexed hash table.  Hash words are
int32 tensors holding the reference's uint32 bit patterns, and ``hits`` is
the port's uint32 counter (int64, :func:`~repro_torch.core.types.sat_add`).

A repeated slot within one batch resolves as the reference's
``.at[].set`` does: the last lane wins (``last_writer``); the version is a
scatter-add, exact in any order.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.hashing import fold_hash, hash128_u32_np
from ..core.scatter_free import last_writer
from ..core.types import (
    COUNTER_DTYPE, HKEY_LANES, OP_CRN_REQ, OP_F_REP, OP_F_REQ, OP_R_REP,
    OP_R_REQ, OP_W_REP, OP_W_REQ, ROUTE_CLIENT, ROUTE_DROP, ROUTE_SERVER,
    PacketBatch, resolve_device, sat_add,
)

N_PROBES = 2
I32 = torch.int32


class NetCacheState(NamedTuple):
    hkeys: torch.Tensor     # int32[T, 4] (uint32 bit patterns)
    occupied: torch.Tensor  # bool[T]
    kidx: torch.Tensor      # int32[T]
    valid: torch.Tensor     # bool[T]
    val: torch.Tensor       # uint8[T, value_limit]
    vlen: torch.Tensor      # int32[T]
    hits: torch.Tensor      # int64[] running hit count (uint32, sat_add)
    version: torch.Tensor   # int32[T]


def init_netcache(table_size: int, value_limit: int,
                  device=None) -> NetCacheState:
    t, d = table_size, resolve_device(device)
    return NetCacheState(
        hkeys=torch.zeros((t, HKEY_LANES), dtype=I32, device=d),
        occupied=torch.zeros((t,), dtype=torch.bool, device=d),
        kidx=torch.full((t,), -1, dtype=I32, device=d),
        valid=torch.zeros((t,), dtype=torch.bool, device=d),
        val=torch.zeros((t, value_limit), dtype=torch.uint8, device=d),
        vlen=torch.zeros((t,), dtype=I32, device=d),
        hits=torch.zeros((), dtype=COUNTER_DTYPE, device=d),
        version=torch.zeros((t,), dtype=I32, device=d),
    )


def _probe_slots(hkey: torch.Tensor, table_size: int) -> torch.Tensor:
    """int32[B, N_PROBES] candidate slots."""
    return torch.stack([fold_hash(hkey, table_size, salt=100 + p)
                        for p in range(N_PROBES)], dim=-1)


def _match(st: NetCacheState, hkey: torch.Tensor) -> torch.Tensor:
    """int32[B]: the first probe slot holding ``hkey``, or -1."""
    slots = _probe_slots(hkey, st.occupied.shape[0])
    sl = slots.long()
    eq = (st.hkeys[sl] == hkey[:, None, :]).all(dim=-1) & st.occupied[sl]
    slot = torch.full_like(slots[:, 0], -1)
    for p in reversed(range(N_PROBES)):     # the first matching probe wins
        slot = torch.where(eq[:, p], slots[:, p], slot)
    return slot


def netcache_step(st: NetCacheState, pkts: PacketBatch):
    """One batch through the NetCache data plane.

    Returns ``(state, route, flag, switch_reply, n_hit)``: ``switch_reply``
    marks the R-REQ lanes the switch answers, ``n_hit`` (int32) counts
    them.
    """
    op, valid = pkts.op, pkts.valid
    slot = _match(st, pkts.hkey)
    hit = (slot >= 0) & valid
    safe = torch.where(hit, slot, 0).long()

    r_req = valid & (op == OP_R_REQ)
    w_req = valid & (op == OP_W_REQ)
    r_rep = valid & (op == OP_R_REP)
    w_rep = valid & (op == OP_W_REP)
    f_rep = valid & (op == OP_F_REP)
    passthru = valid & ((op == OP_CRN_REQ) | (op == OP_F_REQ))

    entry_valid = st.valid[safe] & hit
    switch_reply = r_req & hit & entry_valid
    n_hit = torch.sum(switch_reply, dtype=I32)

    # writes invalidate (and bump the version), then write through to the
    # server with FLAG=1 if cached
    t = st.occupied.shape[0]
    w_cached = w_req & hit
    widx = torch.where(w_cached, slot, t).long()
    bumps = torch.zeros(t + 1, dtype=I32, device=slot.device).scatter_add(
        0, widx, torch.ones_like(slot))[:t]
    valid_arr = st.valid & (bumps == 0)
    version = st.version + bumps
    flag = torch.where(w_cached, 1, pkts.flag)

    # write and fetch replies refresh the stored value: the last lane
    # installing a slot wins
    install = (w_rep | f_rep) & hit & (pkts.flag >= 1)
    writer, written = last_writer(slot, install, t)
    limit = st.val.shape[1]
    valid_arr = valid_arr | written
    val = torch.where(written[:, None], pkts.val[writer, :limit], st.val)
    vlen = torch.where(written,
                       torch.clamp(pkts.vlen[writer], max=limit), st.vlen)

    to_server = (r_req & ~switch_reply) | w_req | passthru
    to_client = r_rep | w_rep | switch_reply
    route = torch.full_like(op, ROUTE_DROP)
    route = torch.where(to_server, ROUTE_SERVER, route)
    route = torch.where(to_client, ROUTE_CLIENT, route)

    st2 = st._replace(valid=valid_arr, version=version, val=val, vlen=vlen,
                      hits=sat_add(st.hits, n_hit))
    return st2, route, flag, switch_reply, n_hit


def netcache_install(st: NetCacheState, keys: np.ndarray, vlens: np.ndarray,
                     key_size: int, value_limit: int, key_limit: int = 16,
                     ) -> tuple[NetCacheState, int]:
    """Controller-side preload of the cacheable subset of ``keys``.

    Keys over ``key_limit`` bytes and values over ``value_limit`` bytes
    are refused (the paper's motivation).  A placed key is valid with its
    version-0 synthetic bytes, as the paper's evaluation preloads the
    cache before measuring.  Runs on the host; returns the state on its
    device and the number installed.
    """
    from ..kvstore.store import synth_value_np

    dev = st.hkeys.device
    np_of = lambda x: x.detach().cpu().numpy().copy()
    t = st.occupied.shape[0]
    hkeys, occupied, kidx = np_of(st.hkeys), np_of(st.occupied), \
        np_of(st.kidx)
    valid, val, vlen_arr = np_of(st.valid), np_of(st.val), np_of(st.vlen)
    width = val.shape[1]

    installed = 0
    for k, vl in zip(np.asarray(keys), np.asarray(vlens)):
        if key_size > key_limit or vl > value_limit:
            continue  # uncacheable under NetCache's hardware limits
        hk = hash128_u32_np(np.int32(k))
        placed = False
        for p in range(N_PROBES):
            s = int(_fold_np(hk, t, salt=100 + p))
            if not occupied[s] or kidx[s] == k:
                hkeys[s] = hk.view(np.int32)
                occupied[s] = True
                kidx[s] = k
                valid[s] = True
                v = synth_value_np(int(k), 0, width)
                val[s] = np.where(np.arange(width) < vl, v, 0)
                vlen_arr[s] = vl
                placed = True
                break
        installed += int(placed)
    t_of = lambda a: torch.from_numpy(a).to(dev)
    return st._replace(hkeys=t_of(hkeys), occupied=t_of(occupied),
                       kidx=t_of(kidx), valid=t_of(valid), val=t_of(val),
                       vlen=t_of(vlen_arr)), installed


def _fold_np(hkey: np.ndarray, width: int, salt: int) -> np.int32:
    """Host twin of :func:`~repro_torch.core.hashing.fold_hash` for one
    key's uint32[4] hash words."""
    def sm(x: int) -> int:
        x &= 0xFFFFFFFF
        x ^= x >> 16
        x = (x * 0x7FEB352D) & 0xFFFFFFFF
        x ^= x >> 15
        x = (x * 0x846CA68B) & 0xFFFFFFFF
        x ^= x >> 16
        return x
    h = sm(int(hkey[0]) ^ ((salt * 0x9E3779B9 + 0x85EBCA6B) & 0xFFFFFFFF))
    h = (h ^ int(hkey[1]) ^ (int(hkey[2]) >> 7)
         ^ ((int(hkey[3]) << 3) & 0xFFFFFFFF))
    return np.int32(sm(h) % width)
