"""OrbitCache-backed distributed KV service (port of
``repro.serving.orbit_service``).

The paper's architecture as a service over the ring positions of
:mod:`repro_torch.core.distributed`: a value store hash-partitioned
across the positions (the storage servers), and the orbit ring
circulating the hot set.  Each step, every position submits a batch of key
lookups:

  hot hit -> request-table enqueue; a visiting orbit line answers within
             D hops, with no store access and no exchange lane used;
  miss    -> sent to the key's owner position over a fixed-quota
             all-to-all (the "forward to server" path); lookups beyond the
             quota are not answered this step (``cold`` is false).

The step runs in phases between the ring's collectives: the ring step
(rotation included), the request blocks' all-to-all, the owners' store
reads, the value blocks' all-to-all, the answers.  A :class:`StackedRing`
runs each phase under ``torch.func.vmap`` on the stacked state, a
:class:`ProcessRing` on its own position.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import distributed as ring_mod
from repro_torch.core.hashing import hash128_u32
from repro_torch.core.scatter_free import set_drop
from repro_torch.core.types import I32, OP_R_REQ, PacketBatch, resolve_device


class ServiceConfig(NamedTuple):
    num_entries: int = 128       # hot-set size (small cache effect)
    queue_size: int = 8
    slice_len: int = 8           # orbit lines resident per position
    value_pad: int = 256
    local_batch: int = 64        # lookups per position per step
    a2a_quota: int = 16          # cold lanes per (src, dst) pair per step
    clones_per_visit: int = 4


class ServiceState(NamedTuple):
    ring: ring_mod.RingState
    store_vals: torch.Tensor     # uint8[keys_local, value_pad] per position
    store_keys: torch.Tensor     # int32[keys_local] global key ids


SERVICE_DIMS = ServiceState(ring=ring_mod.RING_DIMS, store_vals=0,
                            store_keys=0)


def init_service(cfg: ServiceConfig, num_keys: int, num_devices: int,
                 key_dtype=torch.uint8, device=None) -> ServiceState:
    """The stacked state of ``num_devices`` positions (a
    :class:`~repro_torch.core.distributed.ProcessRing` takes its rank's
    with ``ring.local(st, SERVICE_DIMS)``)."""
    d = resolve_device(device)
    keys_local = num_keys // num_devices
    rs = ring_mod.init_ring_state(cfg.num_entries, cfg.queue_size,
                                  cfg.slice_len, cfg.value_pad, d)
    stack = lambda x: x.expand((num_devices,) + x.shape).clone()
    return ServiceState(
        ring=ring_mod.tree_map_dims(stack, rs, ring_mod.RING_DIMS),
        store_vals=torch.zeros((num_devices, keys_local, cfg.value_pad),
                               dtype=key_dtype, device=d),
        store_keys=torch.arange(num_keys, dtype=I32, device=d).reshape(
            num_devices, keys_local),
    )


def owner_of(key: torch.Tensor, num_devices: int, keys_local: int):
    """(owner position, index in its shard) of each key."""
    return (torch.div(key, keys_local, rounding_mode="floor"),
            torch.remainder(key, keys_local))


def _lookups(keys: torch.Tensor, mask: torch.Tensor,
             value_pad: int) -> PacketBatch:
    b = keys.shape[0]
    zeros = torch.zeros(b, dtype=I32, device=keys.device)
    return PacketBatch(
        op=torch.full((b,), OP_R_REQ, dtype=I32, device=keys.device),
        seq=torch.arange(b, dtype=I32, device=keys.device),
        hkey=hash128_u32(keys), flag=zeros, kidx=keys, vlen=zeros,
        client=zeros, port=zeros, server=zeros,
        ts=torch.zeros(b, dtype=torch.float32, device=keys.device),
        valid=mask,
        val=torch.zeros((b, value_pad), dtype=torch.uint8,
                        device=keys.device))


def _route_cold(keys, mask, miss, keys_local: int, d: int, q: int):
    """The request blocks of a position: ``(req_buf int32[d, q] shard
    indices, src_slot int32[d, q] asking lane or -1, within_quota)``."""
    b = keys.shape[0]
    owner, local_idx = owner_of(keys, d, keys_local)
    miss = miss & mask
    ar = torch.arange(d, dtype=owner.dtype, device=keys.device)
    onehot = ((owner[:, None] == ar[None, :]) & miss[:, None]).to(I32)
    rank = torch.cumsum(onehot, 0, dtype=I32) - onehot
    lane = torch.gather(rank, 1, owner[:, None].long())[:, 0]
    within_quota = miss & (lane < q)
    dest = torch.where(within_quota, owner * q + lane, d * q)
    req_buf = set_drop(torch.zeros(d * q, dtype=I32, device=keys.device),
                       dest, local_idx.to(I32)).reshape(d, q)
    src_slot = set_drop(torch.full((d * q,), -1, dtype=I32,
                                   device=keys.device),
                        dest, torch.arange(b, dtype=I32, device=keys.device)
                        ).reshape(d, q)
    return req_buf, src_slot, within_quota


def _read_store(store_vals, got_idx):
    keys_local = store_vals.shape[0]
    return store_vals[torch.clamp(got_idx, 0, keys_local - 1).long()]


def _answer(back, src_slot, b: int):
    """Scatter the returned value blocks into the asking lanes."""
    d, q, pad = back.shape
    flat_slot = src_slot.reshape(d * q)
    res = torch.zeros((b, pad), dtype=back.dtype, device=back.device)
    return set_drop(res, torch.where(flat_slot >= 0, flat_slot, b),
                    back.reshape(d * q, pad))


def service_step_local(st: ServiceState, keys: torch.Tensor,
                       mask: torch.Tensor, cfg: ServiceConfig, ring):
    """One service step at every position of ``ring``.  ``keys`` int32[B]
    lookups and ``mask`` bool[B] (idle lanes carry no request), each with
    a leading ``[D]`` in a stacked ring.

    Returns ``(state', values uint8[B, pad], cold bool[B], hot bool[B],
    serve)``: ``values`` holds the cold answers (``cold``: sent within the
    quota and answered this step); ``hot`` marks the lookups queued for
    the orbit, answered in ``serve`` as lines visit.
    """
    d, q = ring.size, cfg.a2a_quota
    keys_local = st.store_keys.shape[-1]
    b = keys.shape[-1]

    # 1) hot path through the orbit ring
    pk = ring.map(lambda k, m: _lookups(k, m, cfg.value_pad), (keys, mask),
                  (0, 0), 0)
    rst, serve = ring_mod.ring_step(st.ring, pk, cfg.clones_per_visit, ring)

    # 2) cold path: quota'd all-to-all to the owner positions
    req_buf, src_slot, within_quota = ring.map(
        lambda k, m, miss: _route_cold(k, m, miss, keys_local, d, q),
        (keys, mask, serve.miss), (0, 0, 0), 0)
    got_idx = ring.all_to_all(req_buf)
    vals_out = ring.map(_read_store, (st.store_vals, got_idx), (0, 0), 0)
    back = ring.all_to_all(vals_out)
    res = ring.map(lambda v, s: _answer(v, s, b), (back, src_slot), (0, 0), 0)

    # hot lookups are answered by the ring as lines rotate past
    hot_mask = mask & ~serve.miss
    new_state = ServiceState(ring=rst, store_vals=st.store_vals,
                             store_keys=st.store_keys)
    return new_state, res, within_quota, hot_mask, serve


def make_service_step(ring, cfg: ServiceConfig):
    """``service_step_local`` bound to a ring: ``step(st, keys, mask)``."""
    def step(st: ServiceState, keys: torch.Tensor, mask: torch.Tensor):
        return service_step_local(st, keys, mask, cfg, ring)
    return step
