"""Circular-queue request table (port of ``repro.core.request_table``,
paper §3.4).

Metadata arrays are indexed by ``ReqIdx = CacheIdx * S + i`` and the
pointer arrays (qlen / front / rear) by ``CacheIdx``, so queues of
different keys never collide.  A batch enqueue stands in for the
switch's serial packet order: two same-key requests in one batch land in
consecutive slots, each offset by the number of earlier same-key
enqueues in the batch (an exclusive cumulative sum of the one-hot key
matrix).  The fused ``kernels.subround`` pass does admission, the
metadata apply and the serving round inside the kernel; these functions
are the composed form it is held against.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .scatter_free import set_drop, unique_writer
from .types import RequestTable

I32 = torch.int32


class EnqueueResult(NamedTuple):
    table: RequestTable
    accepted: torch.Tensor   # bool[B] stored in the table
    overflow: torch.Tensor   # bool[B] cached key but queue full (to server)


def enqueue(table: RequestTable, cidx: torch.Tensor, want: torch.Tensor,
            client: torch.Tensor, seq: torch.Tensor, port: torch.Tensor,
            ts: torch.Tensor, kidx: torch.Tensor | None = None,
            ) -> EnqueueResult:
    """Enqueue a packet batch: ``cidx`` int32[B] (-1 = not enqueueing),
    ``want`` bool[B], the metadata int32[B] / float32[B] ``ts``, and
    optionally the requested key ``kidx`` int32[B]."""
    c, s = table.num_entries, table.queue_size
    safe = torch.where(want, cidx, 0).to(I32)
    ar = torch.arange(c, dtype=I32, device=cidx.device)
    onehot = (safe[:, None] == ar[None, :]) & want[:, None]
    oh = onehot.to(I32)
    prior = torch.cumsum(oh, dim=0, dtype=I32) - oh          # exclusive
    offset = torch.gather(prior, 1, safe[:, None].long())[:, 0]

    free_i = (s - table.qlen)[safe.long()]
    accepted = want & (offset < free_i)
    overflow = want & ~accepted

    slot = torch.remainder(table.rear[safe.long()] + offset, s)
    # accepted packets of one key take consecutive slots, so every
    # written slot has one writer
    writer, written = unique_writer(safe * s + slot, accepted, c * s)
    new_counts = torch.sum(onehot & accepted[:, None], dim=0, dtype=I32)
    table2 = apply_winners(table, writer, written, new_counts, client, seq,
                           port, ts, kidx=kidx)
    return EnqueueResult(table2, accepted, overflow)


def apply_winners(table: RequestTable, writer: torch.Tensor,
                  written: torch.Tensor, new_counts: torch.Tensor,
                  client: torch.Tensor, seq: torch.Tensor, port: torch.Tensor,
                  ts: torch.Tensor, kidx: torch.Tensor | None = None,
                  ) -> RequestTable:
    """Apply an admission pass: ``writer`` [C * S] winning lane per slot,
    ``written`` bool[C * S], ``new_counts`` int32[C] accepted enqueues per
    entry."""
    s = table.queue_size
    w = writer.long()

    def put(arr, val):
        return torch.where(written, val[w], arr)

    return RequestTable(
        client=put(table.client, client),
        seq=put(table.seq, seq),
        port=put(table.port, port),
        ts=put(table.ts, ts),
        acked=torch.where(written, 0, table.acked),
        kidx=table.kidx if kidx is None else put(table.kidx, kidx),
        qlen=table.qlen + new_counts,
        front=table.front,
        rear=torch.remainder(table.rear + new_counts, s),
    )


class DequeueResult(NamedTuple):
    table: RequestTable
    # per (entry, j) served request metadata, j in [0, max_serves)
    served: torch.Tensor   # bool[C, J]
    client: torch.Tensor   # int32[C, J]
    seq: torch.Tensor      # int32[C, J]
    port: torch.Tensor     # int32[C, J]
    ts: torch.Tensor       # float32[C, J]
    kidx: torch.Tensor     # int32[C, J] requested key of each request


def peek_front(table: RequestTable, budget: torch.Tensor, max_serves: int,
               ) -> DequeueResult:
    """Read (not remove) up to ``min(qlen, budget)`` front items per key;
    ``budget`` int32[C].  :func:`pop` removes them, so multi-fragment
    items can delay it through the ACK counter (paper §3.10)."""
    c, s = table.num_entries, table.queue_size
    dev = table.qlen.device
    j = torch.arange(max_serves, dtype=I32, device=dev)[None, :]
    n_serve = torch.minimum(table.qlen, budget)
    served = j < n_serve[:, None]
    slot = torch.remainder(table.front[:, None] + j, s)
    flat = (torch.arange(c, dtype=I32, device=dev)[:, None] * s
            + slot).long()
    return DequeueResult(table=table, served=served,
                         client=table.client[flat], seq=table.seq[flat],
                         port=table.port[flat], ts=table.ts[flat],
                         kidx=table.kidx[flat])


def pop(table: RequestTable, n_pop: torch.Tensor) -> RequestTable:
    """Remove ``n_pop`` (int32[C]) items from the front of each queue."""
    n_pop = torch.minimum(n_pop.to(I32), table.qlen)
    return table._replace(
        qlen=table.qlen - n_pop,
        front=torch.remainder(table.front + n_pop, table.queue_size),
    )


def ack_fragments(table: RequestTable, cidx_range: torch.Tensor,
                  frag_hits: torch.Tensor, frags: torch.Tensor,
                  ) -> tuple[RequestTable, torch.Tensor]:
    """Multi-fragment ACK (paper §3.10): add to the ``acked`` counter of
    each key's front slot the fragment lines that served it this pass; the
    request is ready to pop once ``acked + frag_hits >= frags``.

    ``cidx_range`` int32[C] (arange), ``frag_hits`` int32[C], ``frags``
    int32[C].  Returns ``(table', ready int32[C] in {0, 1})``.
    """
    s = table.queue_size
    flat_front = cidx_range * s + table.front
    has = table.qlen > 0
    new_acked = torch.where(has, table.acked[flat_front.long()] + frag_hits,
                            0).to(I32)
    ready = (new_acked >= frags) & has & (frag_hits > 0)
    acked = set_drop(table.acked, flat_front,
                     torch.where(ready, 0, new_acked).to(I32))
    return table._replace(acked=acked), ready.to(I32)
