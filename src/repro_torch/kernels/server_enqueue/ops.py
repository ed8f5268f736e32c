"""Wrapper for the server_enqueue kernel.

:func:`server_enqueue` launches the Hopper kernel (``kernel.cu``) on CUDA
tensors and refuses any other (``repro_torch.kernels`` runs the plain
version, ``ref.server_enqueue_ref``, where the kernel does not).  Inputs
are a server step's lanes [B] (int32 ``server``, bool ``to_server`` and
the eight fields in ring order: int32 op, kidx, seq, client, port, flag,
vlen and float32 ts), the eight rings [n, q] of the same dtypes, and int32
``qlen`` and ``rear`` [n].
"""
from __future__ import annotations

import torch

I32, F32 = torch.int32, torch.float32
RING_DTYPES = (I32,) * 7 + (F32,)
MAX_WORDS = 2**31     # the kernel indexes in uint32
MAX_POINTS = 65535    # the grid's second dimension


def server_enqueue(server, to_server, fields, rings, qlen, rear,
                   p: int | None = None):
    """``(rings', qlen', rear', new_counts, dropped_now, accepted)`` on the
    card, in one launch: the eight new rings [n, q], int32 [n] counts and
    bool ``accepted`` [B].

    ``p`` an int: ``p`` points, each input with a leading ``[p]``, or
    without it where every point shares it (a stride of 0); every output
    ``[p, ...]``."""
    args = [server, to_server, *fields, *rings, qlen, rear]
    if len(args) != 20:
        raise ValueError(f"server_enqueue: 8 fields and 8 rings, not "
                         f"{len(fields)} and {len(rings)}")
    dev = server.device
    if dev.type != "cuda":
        raise ValueError(f"server_enqueue: the kernel takes CUDA tensors, "
                         f"not {dev}")

    from repro_torch.kernels import LAUNCHES

    from . import kernel

    b = server.shape[-1]
    n, q = rings[0].shape[-2:]
    pts = 1 if p is None else p
    if pts > MAX_POINTS or pts * max(b, n * q) >= MAX_WORDS:
        raise ValueError(f"server_enqueue: {pts} points of {b} lanes and "
                         f"{n} x {q} slots; the kernel takes at most "
                         f"{MAX_POINTS} points and {MAX_WORDS} words")
    want = ([("server", I32, (b,)), ("to_server", torch.bool, (b,))]
            + [(f"field {i}", dt, (b,)) for i, dt in enumerate(RING_DTYPES)]
            + [(f"ring {i}", dt, (n, q)) for i, dt in enumerate(RING_DTYPES)]
            + [("qlen", I32, (n,)), ("rear", I32, (n,))])
    strides = []
    for a, (name, dt, shp) in zip(args, want):
        own = p is not None and a.dim() == len(shp) + 1
        full = (p,) + shp if own else shp
        if a.device != dev or a.dtype != dt or tuple(a.shape) != full:
            raise ValueError(f"server_enqueue: {name} is {a.dtype}"
                             f"{tuple(a.shape)} on {a.device}; the kernel "
                             f"takes {dt}{full} on {dev}")
        strides.append(a[0].numel() if own else 0)
    args = [a.contiguous() for a in args]
    lead = () if p is None else (p,)
    outs = ([torch.empty(lead + (n, q), dtype=dt, device=dev)
             for dt in RING_DTYPES]
            + [torch.empty(lead + (n,), dtype=I32, device=dev)
               for _ in range(4)]
            + [torch.empty(lead + (b,), dtype=torch.bool, device=dev)])
    kernel.launch([a.data_ptr() for a in args], strides,
                  [o.data_ptr() for o in outs], pts, b, n, q,
                  torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["server_enqueue"] += 1
    return outs[:8], *outs[8:]
