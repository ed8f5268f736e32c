"""Wrapper for the count-min kernel: row indices, tile size, launch.

``rows_for`` folds each 128-bit key hash into five sketch columns
(``fold_hash`` with salts 0-4); the tile is the reference's
``min(block_b, max(8, B))``.  The reference pads the batch to a whole
number of tiles with unmasked lanes, which add nothing and report nothing,
so neither the kernel nor the plain version needs the padding.

On CUDA tensors :func:`update_query` launches the Hopper kernel
(``kernel.cu``), one block per sketch; on CPU tensors it runs the plain
version (``ref.cms_update_query_fast``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.hashing import fold_hash

from . import ref

DEPTH = ref.DEPTH
I32 = torch.int32


def rows_for(hkey: torch.Tensor, width: int) -> torch.Tensor:
    """int32[B, DEPTH] sketch columns for int32[B, 4] key hashes."""
    return torch.stack([fold_hash(hkey, width, salt=d) for d in range(DEPTH)],
                       dim=-1)


def tile_for(b: int, block_b: int = 256) -> int:
    """The reference dispatcher's tile: ``min(block_b, max(8, B))``."""
    return min(block_b, max(8, b))


def update_query(idx, mask, counts, tile: int):
    """``(counts', est)`` for ``idx[B, 5]``, ``mask[..., B]`` and
    ``counts[..., 5, W]`` (a leading axis of sketches shares ``idx``)."""
    mask = mask.to(I32)
    dev = idx.device
    if dev.type == "cpu":
        return ref.cms_update_query_fast(idx, mask, counts, block_b=tile)
    if dev.type != "cuda":
        raise ValueError(f"cms: no kernel for device {dev}")

    from repro_torch.kernels import LAUNCHES

    from . import kernel

    b, w = idx.shape[0], counts.shape[-1]
    lead = tuple(counts.shape[:-2])
    for name, a, dt, shp in (("idx", idx, I32, (b, DEPTH)),
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
    kernel.launch(idx.data_ptr(), mask.data_ptr(), counts.data_ptr(),
                  out.data_ptr(), est.data_ptr(), n, b, w, tile,
                  torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["cms"] += 1
    return out, est


def cms_update_query(hkey, mask, counts, block_b: int = 256):
    """Fused count-min update + query for int32[B, 4] key hashes."""
    idx = rows_for(hkey, counts.shape[-1])
    return update_query(idx, mask, counts, tile_for(hkey.shape[0], block_b))


def update_query_batched(idx, mask, counts, tile: int):
    """P points' sketches in one call: ``counts[P, n, 5, W]`` and
    ``mask[P, n, B]`` (``n`` sketches a point), ``idx[P, B, 5]``, or
    ``idx[B, 5]`` shared by every point.  Returns ``(counts' [P, n, 5, W],
    est [P, n, B])``.

    On CUDA tensors one launch of P x n blocks, sketch ``s`` reading the
    row indices of point ``s // n``; on CPU tensors the plain version once
    per point."""
    mask = mask.to(I32)
    dev = idx.device
    p = counts.shape[0]
    shared = idx.dim() == 2
    if dev.type == "cpu":
        per = [ref.cms_update_query_fast(idx if shared else idx[i], mask[i],
                                         counts[i], block_b=tile)
               for i in range(p)]
        return tuple(torch.stack(x) for x in zip(*per))
    if dev.type != "cuda":
        raise ValueError(f"cms: no kernel for device {dev}")

    from repro_torch.kernels import LAUNCHES

    from . import kernel

    b, w = idx.shape[-2], counts.shape[-1]
    lead = tuple(counts.shape[:-2])
    idx_shape = (b, DEPTH) if shared else (p, b, DEPTH)
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
    kernel.launch_batched(idx.data_ptr(), 0 if shared else b * DEPTH,
                          n // p, mask.data_ptr(), counts.data_ptr(),
                          out.data_ptr(), est.data_ptr(), n, b, w, tile,
                          torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["cms"] += 1
    return out, est
