"""Plain PyTorch version of the hot_gather kernel (port of
``repro.kernels.hot_gather.ref``)."""
from __future__ import annotations

import torch


def hot_gather_ref(ids, hot_ids, rows):
    """``out[b] = sum_c [ids[b] == hot_ids[c]] * rows[c]`` over every
    match, and ``hit[b]`` = any match (int32)."""
    eq = ids[:, None] == hot_ids[None, :]                      # [B, C]
    out = torch.sum(eq.to(rows.dtype)[:, :, None] * rows[None, :, :], dim=1,
                    dtype=rows.dtype)
    return out, torch.any(eq, dim=1).to(torch.int32)
