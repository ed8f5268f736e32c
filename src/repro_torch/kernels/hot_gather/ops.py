"""Wrapper for the hot_gather kernel.

On CUDA tensors it launches the Hopper kernel (``kernel.cu``) for int32,
float32 and bf16 rows (bf16 sums in float32, rounded once); on CPU tensors
it runs the plain version (``ref.hot_gather_ref``).  The reference pads
ids, hot ids and rows to its TPU tiles; the kernel takes any B, C and D
(its tables of hot ids, ``kernel.CHUNK`` ids each, live in shared
memory), so nothing is padded.
"""
from __future__ import annotations

import torch

from . import ref

I32 = torch.int32


def hot_gather(ids, hot_ids, rows):
    """``(out [B, D], hit int32[B])`` for int32 ``ids[B]``, ``hot_ids[C]``
    and ``rows[C, D]``."""
    dev = ids.device
    if dev.type == "cpu":
        return ref.hot_gather_ref(ids, hot_ids, rows)
    if dev.type != "cuda":
        raise ValueError(f"hot_gather: no kernel for device {dev}")

    from repro_torch.kernels import LAUNCHES

    from . import kernel

    b, (c, d) = ids.shape[0], rows.shape
    if d < 1:
        raise ValueError("hot_gather: the kernel needs rows of width >= 1")
    if rows.dtype not in kernel.DTYPES:
        raise ValueError(f"hot_gather: the kernel takes int32, float32 or "
                         f"bf16 rows, not {rows.dtype}")
    for name, a, dt, shp in (("ids", ids, I32, (b,)),
                             ("hot_ids", hot_ids, I32, (c,)),
                             ("rows", rows, rows.dtype, (c, d))):
        if a.device != dev or a.dtype != dt or tuple(a.shape) != shp:
            raise ValueError(f"hot_gather: {name} is {a.dtype}"
                             f"{tuple(a.shape)} on {a.device}; the kernel "
                             f"takes {dt}{shp} on {dev}")
    ids, hot_ids, rows = ids.contiguous(), hot_ids.contiguous(), \
        rows.contiguous()
    out = torch.empty((b, d), dtype=rows.dtype, device=dev)
    hit = torch.empty((b,), dtype=I32, device=dev)
    if b == 0:
        return out, hit
    kernel.launch(ids.data_ptr(), hot_ids.data_ptr(), rows.data_ptr(),
                  out.data_ptr(), hit.data_ptr(), b, c, d, rows.dtype,
                  torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["hot_gather"] += 1
    return out, hit


def hot_gather_batched(ids, hot_ids, rows, p: int):
    """P points in one call: each of ``ids[P, B]``, ``hot_ids[P, C]`` and
    ``rows[P, C, D]`` with a leading point axis, or without one when every
    point shares it.  Returns ``(out [P, B, D], hit int32[P, B])``.

    On CUDA tensors one launch (grid z = P); on CPU tensors the plain
    version once per point."""
    sh = [a.dim() == n for a, n in ((ids, 1), (hot_ids, 1), (rows, 2))]
    dev = ids.device
    if dev.type == "cpu":
        per = [ref.hot_gather_ref(*(a if s else a[i] for a, s in
                                    zip((ids, hot_ids, rows), sh)))
               for i in range(p)]
        return tuple(torch.stack(x) for x in zip(*per))
    if dev.type != "cuda":
        raise ValueError(f"hot_gather: no kernel for device {dev}")

    from repro_torch.kernels import LAUNCHES

    from . import kernel

    b, (c, d) = ids.shape[-1], rows.shape[-2:]
    if d < 1:
        raise ValueError("hot_gather: the kernel needs rows of width >= 1")
    if rows.dtype not in kernel.DTYPES:
        raise ValueError(f"hot_gather: the kernel takes int32, float32 or "
                         f"bf16 rows, not {rows.dtype}")
    lead = [() if s else (p,) for s in sh]
    for name, a, dt, shp in (("ids", ids, I32, lead[0] + (b,)),
                             ("hot_ids", hot_ids, I32, lead[1] + (c,)),
                             ("rows", rows, rows.dtype, lead[2] + (c, d))):
        if a.device != dev or a.dtype != dt or tuple(a.shape) != shp:
            raise ValueError(f"hot_gather: {name} is {a.dtype}"
                             f"{tuple(a.shape)} on {a.device}; the kernel "
                             f"takes {dt}{shp} on {dev}")
    ids, hot_ids, rows = ids.contiguous(), hot_ids.contiguous(), \
        rows.contiguous()
    out = torch.empty((p, b, d), dtype=rows.dtype, device=dev)
    hit = torch.empty((p, b), dtype=I32, device=dev)
    if b == 0:
        return out, hit
    kernel.launch_batched(ids.data_ptr(), 0 if sh[0] else b,
                          hot_ids.data_ptr(), 0 if sh[1] else c,
                          rows.data_ptr(), 0 if sh[2] else c * d,
                          out.data_ptr(), hit.data_ptr(), p, b, c, d,
                          rows.dtype, torch.cuda.current_stream(dev)
                          .cuda_stream)
    LAUNCHES["hot_gather"] += 1
    return out, hit
