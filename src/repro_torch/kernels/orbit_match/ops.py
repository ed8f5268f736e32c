"""Wrapper for the orbit_match kernel.

:func:`orbit_match` launches the Hopper kernel (``kernel.cu``) on CUDA
tensors and refuses any other (``repro_torch.kernels`` runs the plain
version, ``ref.orbit_match_ref``, where the kernel does not).  The
reference pads C to a multiple of 128 with unoccupied entries and B to its
lane tile with ``pop_mask = 0``; neither changes a result, and the kernel
takes any B and C, so nothing is padded.  Hash words are int32 tensors
holding uint32 bit patterns, as everywhere in the port; flags are int32.
"""
from __future__ import annotations

import torch

I32 = torch.int32


def orbit_match(hkey, table_hkeys, occupied, valid, pop_mask=None):
    """``(cidx, hit, valid_hit, pop)`` (int32) on the card for
    ``hkey[B, 4]`` against ``table_hkeys[C, 4]`` with ``occupied``/``valid``
    flags [C] and an optional ``pop_mask[B]``."""
    dev = hkey.device
    if dev.type != "cuda":
        raise ValueError(f"orbit_match: the kernel takes CUDA tensors, not "
                         f"{dev}")

    from repro_torch.kernels import LAUNCHES

    from . import kernel

    b, c = hkey.shape[0], table_hkeys.shape[0]
    if c < 1:
        raise ValueError("orbit_match: the table needs at least one entry")
    args = [("hkey", hkey, (b, 4)), ("table_hkeys", table_hkeys, (c, 4)),
            ("occupied", occupied, (c,)), ("valid", valid, (c,))]
    if pop_mask is not None:
        args.append(("pop_mask", pop_mask, (b,)))
    for name, a, shp in args:
        if a.device != dev or a.dtype != I32 or tuple(a.shape) != shp:
            raise ValueError(f"orbit_match: {name} is {a.dtype}"
                             f"{tuple(a.shape)} on {a.device}; the kernel "
                             f"takes {I32}{shp} on {dev}")
    hkey, table_hkeys = hkey.contiguous(), table_hkeys.contiguous()
    occupied, valid = occupied.contiguous(), valid.contiguous()
    cidx, hit, vhit = (torch.empty((b,), dtype=I32, device=dev)
                       for _ in range(3))
    pop = torch.empty((c,), dtype=I32, device=dev)
    if b == 0:
        return cidx, hit, vhit, pop.zero_()
    if pop_mask is not None:
        pop_mask = pop_mask.contiguous()
    mask_ptr = None if pop_mask is None else pop_mask.data_ptr()
    kernel.launch(hkey.data_ptr(), table_hkeys.data_ptr(),
                  occupied.data_ptr(), valid.data_ptr(), mask_ptr,
                  cidx.data_ptr(), hit.data_ptr(), vhit.data_ptr(),
                  pop.data_ptr(), b, c,
                  torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["orbit_match"] += 1
    return cidx, hit, vhit, pop
