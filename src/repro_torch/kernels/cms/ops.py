"""Wrapper for the count-min kernel: row indices, tile size, launch.

``rows_for`` folds each 128-bit key hash into five sketch columns
(``fold_hash`` with salts 0-4); the tile is the reference's
``min(block_b, max(8, B))``.  The reference pads the batch to a whole
number of tiles with unmasked lanes, which add nothing and report nothing,
so neither the kernel nor the plain version needs the padding.

:func:`update_query` launches the Hopper kernel (``kernel.cu``), one block
per sketch, on CUDA tensors and refuses any other (``repro_torch.kernels``
runs the plain version, ``ref.cms_update_query_fast``, where the kernel
does not).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.hashing import fold_hash

from .kernel import DEPTH

I32 = torch.int32


def rows_for(hkey: torch.Tensor, width: int) -> torch.Tensor:
    """int32[..., B, DEPTH] sketch columns for int32[..., B, 4] key
    hashes."""
    return torch.stack([fold_hash(hkey, width, salt=d) for d in range(DEPTH)],
                       dim=-1)


def tile_for(b: int, block_b: int = 256) -> int:
    """The reference dispatcher's tile: ``min(block_b, max(8, B))``."""
    return min(block_b, max(8, b))


def update_query(idx, mask, counts, tile: int, p: int | None = None):
    """``(counts', est int32[..., B])`` on the card for int32 sketches
    ``counts[..., 5, W]`` and masks ``mask[..., B]``, one block a sketch.

    ``p`` None: every sketch reads the row indices ``idx[B, 5]``.  ``p``
    an int: ``p`` points' sketches, ``counts[p, ..., 5, W]`` and
    ``mask[p, ..., B]``, and ``idx[p, B, 5]``, or ``idx[B, 5]`` shared by
    every point (a stride of 0)."""
    mask = mask.to(I32)
    dev = idx.device
    if dev.type != "cuda":
        raise ValueError(f"cms: the kernel takes CUDA tensors, not {dev}")

    from repro_torch.kernels import LAUNCHES

    from . import kernel

    own = p is not None and idx.dim() == 3
    b, w = idx.shape[-2], counts.shape[-1]
    lead = tuple(counts.shape[:-2])
    if p is not None and lead[:1] != (p,):
        raise ValueError(f"cms: counts {tuple(counts.shape)} lack the "
                         f"leading point axis of {p}")
    idx_shape = ((p,) if own else ()) + (b, DEPTH)
    for name, a, dt, shp in (("idx", idx, I32, idx_shape),
                             ("mask", mask, I32, lead + (b,)),
                             ("counts", counts, I32, lead + (DEPTH, w))):
        if a.device != dev or a.dtype != dt or tuple(a.shape) != shp:
            raise ValueError(f"cms: {name} is {a.dtype}{tuple(a.shape)} on "
                             f"{a.device}; the kernel takes {dt}{shp} on "
                             f"{dev}")
    if tile < 1:
        raise ValueError(f"cms: tile must be >= 1, got {tile}")
    idx, mask = idx.contiguous(), mask.contiguous()
    counts = counts.contiguous()
    out = torch.empty_like(counts)
    est = torch.empty(lead + (b,), dtype=I32, device=dev)
    n = math.prod(lead)
    if n == 0:
        return out, est
    kernel.launch(idx.data_ptr(), b * DEPTH if own else 0,
                  n // (p or 1), mask.data_ptr(), counts.data_ptr(),
                  out.data_ptr(), est.data_ptr(), n, b, w, tile,
                  torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["cms"] += 1
    return out, est
