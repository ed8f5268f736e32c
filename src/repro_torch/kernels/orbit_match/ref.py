"""Plain PyTorch version of the orbit_match kernel (port of
``repro.kernels.orbit_match.ref``)."""
from __future__ import annotations

import torch

I32 = torch.int32


def orbit_match_ref(hkey, table_hkeys, occupied, valid, pop_mask=None):
    """Batched lookup: ``(cidx, hit, valid_hit, pop)``, all int32.

    ``cidx[b]`` is the first occupied entry whose four hash words equal
    ``hkey[b]``, or -1; ``hit`` and ``valid_hit`` (the entry's ``valid``
    flag, read through ``cidx``) follow from it; ``pop[c]`` counts the
    lanes that match entry ``c`` among those with ``pop_mask > 0`` (every
    lane when ``pop_mask`` is None).  Flags are true where ``> 0``.
    """
    c = table_hkeys.shape[0]
    if c == 0:
        raise ValueError("orbit_match: the table needs at least one entry")
    eq = (hkey[:, None, :] == table_hkeys[None, :, :]).all(dim=-1)
    eq = eq & (occupied[None, :] > 0)
    entry = torch.arange(c, dtype=I32, device=hkey.device)
    first = torch.where(eq, entry, c).amin(dim=1)      # the first index wins
    hit = first < c
    cidx = torch.where(hit, first, -1)
    valid_hit = (valid[torch.where(hit, first, 0).long()] > 0) & hit
    pop_eq = eq if pop_mask is None else eq & (pop_mask[:, None] > 0)
    pop = torch.sum(pop_eq, dim=0, dtype=I32)
    return cidx, hit.to(I32), valid_hit.to(I32), pop
