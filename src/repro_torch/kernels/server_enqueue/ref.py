"""Plain PyTorch version of the server_enqueue kernel: ``server.server_step``'s
FIFO enqueue of a window's arrivals, as the window computed it before the
kernel (the reference computes it in ``jnp`` in its ``server_step``; no
Pallas kernel)."""
from __future__ import annotations

import torch

from repro_torch.core.scatter_free import unique_writer

I32 = torch.int32


def server_enqueue_ref(server, to_server, f_op, f_kidx, f_seq, f_client,
                       f_port, f_flag, f_vlen, f_ts, r_op, r_kidx, r_seq,
                       r_client, r_port, r_flag, r_vlen, r_ts, qlen, rear):
    """Enqueue the ``to_server`` lanes [B] on their servers' rings [n, q].

    Each lane's offset is the number of earlier ``to_server`` lanes of its
    server, in lane order; it is accepted if the offset is below its
    server's free room, ``q - qlen``, and then writes its eight fields
    (``f_*``, in ring order) at ``[server, (rear + offset) % q]`` of the
    rings (``r_*``).  Returns the eight new rings, ``qlen'``, ``rear'``,
    ``new_counts`` and ``dropped_now`` int32[n] and ``accepted`` bool[B].
    """
    n, q = r_op.shape
    dev = r_op.device
    ar = lambda m: torch.arange(m, dtype=I32, device=dev)  # noqa: E731

    srv = torch.where(to_server, server, 0).long()
    onehot = (srv[:, None] == ar(n)[None, :]) & to_server[:, None]
    oh = onehot.to(I32)
    prior = torch.cumsum(oh, dim=0, dtype=I32) - oh
    offset = torch.gather(prior, 1, srv[:, None])[:, 0]
    free = (q - qlen)[srv]
    accepted = to_server & (offset < free)
    dropped_now = torch.sum((to_server & ~accepted)[:, None] & onehot, dim=0,
                            dtype=I32)
    slot = (rear[srv] + offset) % q
    writer, written = unique_writer(srv * q + slot, accepted, n * q)
    put = lambda arr, val: torch.where(  # noqa: E731
        written, val[writer], arr.reshape(-1)).reshape(n, q)
    new_counts = torch.sum(onehot & accepted[:, None], dim=0, dtype=I32)
    return (put(r_op, f_op), put(r_kidx, f_kidx), put(r_seq, f_seq),
            put(r_client, f_client), put(r_port, f_port),
            put(r_flag, f_flag), put(r_vlen, f_vlen), put(r_ts, f_ts),
            qlen + new_counts, (rear + new_counts) % q, new_counts,
            dropped_now, accepted)
