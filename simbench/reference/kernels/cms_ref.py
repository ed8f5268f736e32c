"""Plain PyTorch versions of the count-min kernel (port of
``repro.kernels.cms.ref``).

Estimates are taken against the sketch as it stood at the start of each
batch tile, and the tile's increments follow, tile after tile in order:
the result depends on ``block_b``.  Both forms take an optional leading
sketch axis: ``counts[..., 5, W]`` and ``mask[..., B]`` over one shared
``idx[B, 5]``.
"""
from __future__ import annotations

import math

import torch

DEPTH = 5
I32 = torch.int32


def cms_update_query_ref(idx, mask, counts, block_b: int = 256):
    """The one-hot transcription of the kernel: ``(counts', est)``."""
    b, w = idx.shape[0], counts.shape[-1]
    col = torch.arange(w, device=idx.device)
    est = torch.zeros(mask.shape, dtype=I32, device=idx.device)
    for start in range(0, b, block_b):
        sl = slice(start, start + block_b)
        on = (mask[..., sl] > 0)[..., :, None, None]       # [..., TB, 1, 1]
        oh = ((idx[sl][:, :, None] == col) & on).to(I32)   # [..., TB, D, W]
        q = torch.sum(oh * counts[..., None, :, :], dim=-1,
                      dtype=I32).amin(dim=-1)                  # [..., TB]
        est[..., sl] = torch.where(mask[..., sl] > 0, q, 0)
        counts = counts + torch.sum(oh, dim=-3, dtype=I32)
    return counts, est


def cms_update_query_fast(idx, mask, counts, block_b: int = 256):
    """Gather/scatter form of :func:`cms_update_query_ref`, equal to it for
    indices in ``[0, W)``, at O(B * DEPTH) per sketch."""
    b, w = idx.shape[0], counts.shape[-1]
    lead = counts.shape[:-2]
    n = math.prod(lead)
    flat = counts.reshape(n, DEPTH * w).clone()
    msk = mask.reshape(n, b) > 0
    est = torch.zeros((n, b), dtype=I32, device=idx.device)
    cells = idx.long() + torch.arange(DEPTH, device=idx.device) * w  # [B, D]
    for start in range(0, b, block_b):
        sl = slice(start, start + block_b)
        c_t, m_t = cells[sl], msk[:, sl]                   # [TB, D], [n, TB]
        q = flat[:, c_t].amin(dim=-1)                          # [n, TB]
        est[:, sl] = torch.where(m_t, q, 0)
        flat.scatter_add_(
            1, c_t.reshape(1, -1).expand(n, -1),
            m_t[:, :, None].expand(-1, -1, DEPTH).reshape(n, -1).to(I32))
    return flat.reshape(counts.shape), est.reshape(mask.shape)
