"""The kernels' plain versions, called directly (the port's dispatcher
on its ``ref`` backend)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.hashing import fold_hash
from .cms_ref import DEPTH, cms_update_query_fast
from .hot_gather_ref import hot_gather_ref
from .subround_ref import subround_ref


class SubroundOuts(NamedTuple):
    """Outputs of the fused subround op, in the kernel's order."""

    hit: torch.Tensor
    vhit: torch.Tensor
    accepted: torch.Tensor
    overflow: torch.Tensor
    pop: torch.Tensor
    st_valid: torch.Tensor
    st_version: torch.Tensor
    rt_client: torch.Tensor
    rt_seq: torch.Tensor
    rt_port: torch.Tensor
    rt_ts: torch.Tensor
    rt_acked: torch.Tensor
    rt_kidx: torch.Tensor
    qlen: torch.Tensor
    front: torch.Tensor
    rear: torch.Tensor
    ob_live: torch.Tensor
    ob_kidx: torch.Tensor
    ob_version: torch.Tensor
    ob_vlen: torch.Tensor
    ob_frags: torch.Tensor
    val_writer: torch.Tensor
    val_written: torch.Tensor
    served: torch.Tensor
    g_client: torch.Tensor
    g_seq: torch.Tensor
    g_port: torch.Tensor
    g_ts: torch.Tensor
    g_kidx: torch.Tensor
    line_kidx: torch.Tensor
    line_vlen: torch.Tensor
    line_version: torch.Tensor


def subround(*args, queue_size: int, max_frags: int, max_serves: int):
    return SubroundOuts(*subround_ref(*args, queue_size=queue_size,
                                      max_frags=max_frags,
                                      max_serves=max_serves))


def cms_update_query(hkey, mask, counts, block_b: int = 256):
    """``(counts', est)``: the count-min update and query, each tile of
    ``min(block_b, max(8, B))`` lanes against the sketch at its start."""
    w = counts.shape[-1]
    idx = torch.stack([fold_hash(hkey, w, salt=d) for d in range(DEPTH)],
                      dim=-1)
    tile = min(block_b, max(8, hkey.shape[0]))
    return cms_update_query_fast(idx, mask.to(torch.int32), counts,
                                 block_b=tile)


def hot_gather(ids, hot_ids, rows):
    return hot_gather_ref(ids, hot_ids, rows)
