"""Distributed orbit ring (port of ``repro.core.distributed``).

The switch data plane spread over D ring positions, the recirculation
port becoming the ring: cache lines (self-contained key, version, value
records, the paper's cache packets) hop one position every step.  Each
position keeps

  * a replica of the (small) lookup and state tables,
  * its own circular-queue request table: requests submitted there wait
    there,
  * the slice of orbit lines visiting it.

One revolution visits every position's request table, so a queued request
is served within D hops; requests never travel the ring, only the lines
do.  PRE cloning becomes "serve up to ``clones_per_visit`` queued requests
per visiting line without consuming it".

A ring object carries the communication, in one of two forms:

* :class:`ProcessRing`: one position per process of a
  ``torch.distributed`` group (gloo on the CPU, nccl on cards); the state
  is the position's own, and the rotation is a ring of
  ``batch_isend_irecv`` (send to ``rank + 1``, receive from ``rank - 1``).
* :class:`StackedRing`: all D positions in one process on one device,
  stacked on dim 0 (the reference's global shapes: ring leaves ``[D,
  ...]``, ``lookup`` and ``state`` replicated); the per-position step runs
  under ``torch.func.vmap`` and the rotation is a roll along dim 0.

The ring matches with the plain :func:`~repro_torch.core.lookup.lookup`,
as the reference's does: it launches no kernel.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.distributed as dist

from . import lookup as lk
from . import request_table as rt
from .scatter_free import last_writer, set_drop
from .types import (
    COUNTER_DTYPE, I32, OP_R_REQ, OP_W_REQ, LookupTable, PacketBatch,
    RequestTable, StateTable, resolve_device, sat_add,
)

U32_MASK = 0xFFFFFFFF


class OrbitSlice(NamedTuple):
    """Orbit lines currently resident at a ring position."""

    live: torch.Tensor     # bool[L]
    cidx: torch.Tensor     # int32[L] cache entry carried (-1 dead)
    kidx: torch.Tensor     # int32[L]
    version: torch.Tensor  # int32[L]
    vlen: torch.Tensor     # int32[L]
    val: torch.Tensor      # uint8[L, value_pad]


class RingState(NamedTuple):
    lookup: LookupTable    # replicated match-action tables
    state: StateTable
    reqtab: RequestTable   # this position's request queues
    slice: OrbitSlice      # resident orbit lines
    popularity: torch.Tensor  # int64[C] uint32 counts, wrapping as uint32
    overflow: torch.Tensor    # int64[] (sat_add)
    hits: torch.Tensor        # int64[] (sat_add)


# which leaves are per position (dim 0 of a StackedRing) and which are
# replicated; a vmap dims tree
RING_DIMS = RingState(lookup=None, state=None, reqtab=0, slice=0,
                      popularity=0, overflow=0, hits=0)


def init_ring_state(num_entries: int, queue_size: int, slice_len: int,
                    value_pad: int, device=None) -> RingState:
    """One position's empty state."""
    c, s, l = num_entries, queue_size, slice_len
    d = resolve_device(device)
    full = lambda n, v, dt=I32: torch.full((n,), v, dtype=dt, device=d)
    return RingState(
        lookup=LookupTable(hkeys=torch.zeros((c, 4), dtype=I32, device=d),
                           occupied=full(c, False, torch.bool),
                           kidx=full(c, -1)),
        state=StateTable(valid=full(c, False, torch.bool), version=full(c, 0)),
        reqtab=RequestTable(
            client=full(c * s, -1), seq=full(c * s, 0), port=full(c * s, 0),
            ts=full(c * s, 0.0, torch.float32), acked=full(c * s, 0),
            kidx=full(c * s, -1), qlen=full(c, 0), front=full(c, 0),
            rear=full(c, 0)),
        slice=OrbitSlice(
            live=full(l, False, torch.bool), cidx=full(l, -1),
            kidx=full(l, -1), version=full(l, 0), vlen=full(l, 0),
            val=torch.zeros((l, value_pad), dtype=torch.uint8, device=d)),
        popularity=torch.zeros(c, dtype=COUNTER_DTYPE, device=d),
        overflow=torch.zeros((), dtype=COUNTER_DTYPE, device=d),
        hits=torch.zeros((), dtype=COUNTER_DTYPE, device=d),
    )


class RingServe(NamedTuple):
    """Replies produced at a position this step."""

    served: torch.Tensor   # bool[C, J]
    client: torch.Tensor   # int32[C, J]
    seq: torch.Tensor      # int32[C, J]
    ts: torch.Tensor       # float32[C, J]
    kidx: torch.Tensor     # int32[C] carried key per entry
    vlen: torch.Tensor     # int32[C]
    val: torch.Tensor      # uint8[C, value_pad] value of the visiting line
    miss: torch.Tensor     # bool[B] request missed the cache (to its shard)


def tree_map_dims(fn, tree, dims):
    """``fn(leaf)`` on the leaves whose dims entry is 0 (a vmap dims tree,
    or one int for the whole tree); ``None`` subtrees pass unchanged."""
    if dims is None:
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        sub = dims if isinstance(dims, tuple) else (dims,) * len(tree)
        return type(tree)(*(tree_map_dims(fn, x, d)
                            for x, d in zip(tree, sub)))
    return fn(tree)


class StackedRing:
    """All ``d`` ring positions in one process, stacked on dim 0."""

    def __init__(self, d: int):
        self.size = d

    def map(self, fn, args, in_dims, out_dims):
        """``fn`` on every position: ``torch.func.vmap`` over dim 0."""
        return torch.func.vmap(fn, in_dims=in_dims, out_dims=out_dims)(*args)

    def rotate(self, tree):
        """Position i's leaves move to position i + 1 (mod d)."""
        return tree_map_dims(lambda x: torch.roll(x, 1, 0), tree, 0)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x[src, dst, ...]`` -> ``[dst, src, ...]``: the tiled
        all-to-all of every position's ``[d, ...]`` blocks."""
        return x.transpose(0, 1).contiguous()


class ProcessRing:
    """One ring position per process of a ``torch.distributed`` group."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def map(self, fn, args, in_dims, out_dims):
        return fn(*args)

    def local(self, tree, dims=0):
        """This rank's position of a stacked tree (``dims`` as vmap's)."""
        return tree_map_dims(lambda x: x[self.rank], tree, dims)

    def _peer(self, r):
        if self.group is None:
            return r
        return dist.get_global_rank(self.group, r)

    def rotate(self, tree):
        """Send every leaf to rank + 1, receive rank - 1's."""
        if self.size == 1:
            return tree
        dst = self._peer((self.rank + 1) % self.size)
        src = self._peer((self.rank - 1) % self.size)
        ops = []

        def swap(x):
            x = x.contiguous()
            y = torch.empty_like(x)
            wire = lambda t: t.view(torch.uint8) if t.dtype == torch.bool \
                else t
            ops.append(dist.P2POp(dist.isend, wire(x), dst, self.group))
            ops.append(dist.P2POp(dist.irecv, wire(y), src, self.group))
            return y

        rotated = tree_map_dims(swap, tree, 0)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return rotated

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """The tiled all-to-all of this rank's ``[d, ...]`` blocks: block j
        goes to rank j, and block i of the result came from rank i."""
        if self.size == 1:
            return x
        x = x.contiguous()
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=self.group)
        return y


def _slice_liveness(st: RingState) -> OrbitSlice:
    """Drop-stale rule at a position: entry evicted / invalid / version
    behind."""
    sl = st.slice
    c = st.lookup.occupied.shape[0]
    safe = torch.clamp(sl.cidx, 0, c - 1).long()
    ok = (sl.live & (sl.cidx >= 0) & st.lookup.occupied[safe]
          & st.state.valid[safe] & (sl.version == st.state.version[safe]))
    return sl._replace(live=ok)


def _position_step(st: RingState, pkts: PacketBatch, clones_per_visit: int,
                   ) -> tuple[RingState, RingServe]:
    """One position's step before the rotation."""
    c = st.lookup.occupied.shape[0]
    valid = pkts.valid
    cidx = lk.lookup(st.lookup, pkts.hkey)
    r_req = valid & (pkts.op == OP_R_REQ)
    hit = r_req & (cidx >= 0)
    safe_cidx = torch.where(hit, cidx, 0)
    entry_valid = st.state.valid[safe_cidx.long()] & hit

    enq = rt.enqueue(st.reqtab, cidx, hit & entry_valid, pkts.client,
                     pkts.seq, pkts.port, pkts.ts)
    miss = ((r_req & ~hit) | (hit & ~entry_valid) | enq.overflow
            | (valid & (pkts.op == OP_W_REQ)))

    def add_at(idx, v):
        """The reference's ``zeros(C).at[idx].add(v, mode='drop')``, every
        repeated index counted."""
        return torch.zeros(c + 1, dtype=torch.int64, device=idx.device
                           ).scatter_add(0, idx.long(),
                                         torch.full_like(idx.long(), v))[:c]

    # the reference's popularity is a uint32 scatter-add, which wraps
    pop = (st.popularity + add_at(torch.where(hit, cidx, c), 1)) & U32_MASK
    n_hit = torch.sum(hit, dtype=I32)
    n_ovf = torch.sum(enq.overflow, dtype=I32)

    sl = _slice_liveness(st._replace(reqtab=enq.table))
    line_dest = torch.where(sl.live, sl.cidx, c)
    # clones_per_visit per live resident line, duplicates of an entry too
    budget = add_at(line_dest, clones_per_visit).to(I32)
    deq = rt.peek_front(enq.table, budget, clones_per_visit)
    reqtab = rt.pop(enq.table, torch.sum(deq.served, dim=1, dtype=I32))

    # entry -> resident line carrying its value; of two live lines of one
    # entry the later wins, as the reference's scatter order has it
    writer, written = last_writer(line_dest, sl.live, c)
    has = written[:, None]
    serve = RingServe(
        served=deq.served, client=deq.client, seq=deq.seq, ts=deq.ts,
        kidx=torch.where(written, sl.kidx[writer], -1).to(I32),
        vlen=torch.where(written, sl.vlen[writer], 0).to(I32),
        val=torch.where(has, sl.val[writer], 0).to(torch.uint8),
        miss=miss,
    )
    st2 = st._replace(reqtab=reqtab, slice=sl, popularity=pop,
                      overflow=sat_add(st.overflow, n_ovf),
                      hits=sat_add(st.hits, n_hit))
    return st2, serve


def ring_step(st: RingState, pkts: PacketBatch, clones_per_visit: int,
              ring) -> tuple[RingState, RingServe]:
    """One data-plane step at every position, then the ring rotation.

    1. match the position's requests; enqueue hits, count misses and
       overflow;
    2. the visiting lines serve up to ``clones_per_visit`` queued requests
       each;
    3. rotate the slice to the next ring position.
    """
    st2, serve = ring.map(
        functools.partial(_position_step, clones_per_visit=clones_per_visit),
        (st, pkts), (RING_DIMS, 0), (RING_DIMS, 0))
    return st2._replace(slice=ring.rotate(st2.slice)), serve


def install_into_slice(sl: OrbitSlice, cidx: torch.Tensor, mask: torch.Tensor,
                       kidx: torch.Tensor, version: torch.Tensor,
                       vlen: torch.Tensor, val: torch.Tensor) -> OrbitSlice:
    """Install fresh lines into a position's free slots (the F-REP arrival
    position): packets claim dead slots in order, and packets beyond the
    free-slot count are dropped."""
    l = sl.live.shape[0]
    order = torch.argsort(sl.live.to(I32), stable=True)      # dead first
    m = mask.to(I32)
    want_rank = torch.cumsum(m, 0, dtype=I32) - m
    n_dead = torch.sum(~sl.live, dtype=I32)
    ok = mask & (want_rank < n_dead)
    dest = torch.where(ok, order[torch.clamp(want_rank, 0, l - 1).long()], l)
    return OrbitSlice(
        live=set_drop(sl.live, dest, True),
        cidx=set_drop(sl.cidx, dest, cidx),
        kidx=set_drop(sl.kidx, dest, kidx),
        version=set_drop(sl.version, dest, version),
        vlen=set_drop(sl.vlen, dest, vlen),
        val=set_drop(sl.val, dest, val),
    )


def make_ring_step(ring, clones_per_visit: int = 4):
    """``ring_step`` bound to a ring: ``step(st, pkts) -> (st', serve)``
    (a :class:`StackedRing` takes and returns the stacked global shapes,
    a :class:`ProcessRing` this rank's own)."""
    def step(st: RingState, pkts: PacketBatch):
        return ring_step(st, pkts, clones_per_visit, ring)
    return step
