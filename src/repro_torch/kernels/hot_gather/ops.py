"""Wrapper for the hot_gather kernel.

:func:`hot_gather` launches the Hopper kernel (``kernel.cu``) for int32,
float32 and bf16 rows (bf16 sums in float32, rounded once) on CUDA
tensors and refuses any other (``repro_torch.kernels`` runs the plain
version, ``ref.hot_gather_ref``, where the kernel does not).  The
reference pads ids, hot ids and rows to its TPU tiles; the kernel takes
any B, C and D (its tables of hot ids, ``kernel.CHUNK`` ids each, live in
shared memory), so nothing is padded.
"""
from __future__ import annotations

import torch

I32 = torch.int32


def hot_gather(ids, hot_ids, rows, p: int | None = None):
    """``(out [B, D], hit int32[B])`` on the card for int32 ``ids[B]``,
    ``hot_ids[C]`` and ``rows[C, D]``.

    ``p`` an int: ``p`` points in one launch (grid z = P), each input with
    a leading point axis of ``p``, or without it where every point shares
    it (a stride of 0); ``(out [p, B, D], hit int32[p, B])``."""
    dev = ids.device
    if dev.type != "cuda":
        raise ValueError(f"hot_gather: the kernel takes CUDA tensors, not "
                         f"{dev}")

    from repro_torch.kernels import LAUNCHES

    from . import kernel

    own = [p is not None and a.dim() > n
           for a, n in ((ids, 1), (hot_ids, 1), (rows, 2))]
    b, (c, d) = ids.shape[-1], rows.shape[-2:]
    if d < 1:
        raise ValueError("hot_gather: the kernel needs rows of width >= 1")
    if rows.dtype not in kernel.DTYPES:
        raise ValueError(f"hot_gather: the kernel takes int32, float32 or "
                         f"bf16 rows, not {rows.dtype}")
    lead = [(p,) if o else () for o in own]
    for name, a, dt, shp in (("ids", ids, I32, lead[0] + (b,)),
                             ("hot_ids", hot_ids, I32, lead[1] + (c,)),
                             ("rows", rows, rows.dtype, lead[2] + (c, d))):
        if a.device != dev or a.dtype != dt or tuple(a.shape) != shp:
            raise ValueError(f"hot_gather: {name} is {a.dtype}"
                             f"{tuple(a.shape)} on {a.device}; the kernel "
                             f"takes {dt}{shp} on {dev}")
    ids, hot_ids, rows = ids.contiguous(), hot_ids.contiguous(), \
        rows.contiguous()
    pt = () if p is None else (p,)
    out = torch.empty(pt + (b, d), dtype=rows.dtype, device=dev)
    hit = torch.empty(pt + (b,), dtype=I32, device=dev)
    if b == 0:
        return out, hit
    kernel.launch(ids.data_ptr(), b if own[0] else 0,
                  hot_ids.data_ptr(), c if own[1] else 0,
                  rows.data_ptr(), c * d if own[2] else 0,
                  out.data_ptr(), hit.data_ptr(), p or 1, b, c, d,
                  rows.dtype, torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["hot_gather"] += 1
    return out, hit
