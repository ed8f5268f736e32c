"""State table (port of ``repro.core.state_table``, paper §3.1, §3.7):
value validity and coherence versions.

Each entry has a valid bit and a version bumped on every invalidation;
an orbit line whose version lags its entry's is stale and dropped on its
next pass.  The fused ``kernels.subround`` pass does this inside the
kernel; these functions are the composed form it is held against.
"""
from __future__ import annotations

import torch

from .types import StateTable

I32 = torch.int32


def _onehot(cidx: torch.Tensor, mask: torch.Tensor, c: int) -> torch.Tensor:
    """bool[B, C] membership matrix."""
    ar = torch.arange(c, dtype=cidx.dtype, device=cidx.device)
    return mask[:, None] & (cidx[:, None] == ar[None, :])


def invalidate(st: StateTable, cidx: torch.Tensor,
               mask: torch.Tensor) -> StateTable:
    """Invalidate the entries hit by write requests (``mask`` bool[B]).

    The version bump counts multiplicity (two writes in one batch add 2),
    so lines fetched between them are both stale."""
    oh = _onehot(cidx, mask, st.valid.shape[0])
    return StateTable(valid=st.valid & ~torch.any(oh, dim=0),
                      version=st.version + torch.sum(oh, dim=0, dtype=I32))


def validate(st: StateTable, cidx: torch.Tensor,
             mask: torch.Tensor) -> StateTable:
    """Re-validate entries on write / fetch replies carrying fresh values."""
    oh = _onehot(cidx, mask, st.valid.shape[0])
    return st._replace(valid=st.valid | torch.any(oh, dim=0))


def apply_batch(st: StateTable, cidx: torch.Tensor, inval_mask: torch.Tensor,
                valid_mask: torch.Tensor) -> StateTable:
    """Write invalidations then reply validations in one pass: equal to
    ``validate(invalidate(st, cidx, inval_mask), cidx, valid_mask)``."""
    c = st.valid.shape[0]
    oh_inv = _onehot(cidx, inval_mask, c)
    oh_val = _onehot(cidx, valid_mask, c)
    return StateTable(
        valid=(st.valid & ~torch.any(oh_inv, dim=0))
        | torch.any(oh_val, dim=0),
        version=st.version + torch.sum(oh_inv, dim=0, dtype=I32),
    )
