"""Wrapper for the reply_values kernel.

:func:`reply_values` launches the Hopper kernel (``kernel.cu``) on CUDA
tensors and refuses any other (``repro_torch.kernels`` runs the plain
version, ``ref.reply_values_ref``, where the kernel does not).  Inputs are
a server step's ``[n, cap]`` lanes: int32 ``kidx``, ``version`` and
``vlen`` and bool ``carries_val``; the output is uint8[n * cap * F, pad].
"""
from __future__ import annotations

import torch

I32 = torch.int32
MAX_BYTES = 2**31     # the kernel indexes its output in uint32


def reply_values(kidx, version, vlen, carries_val, max_frags: int,
                 pad: int, p: int | None = None):
    """uint8[n * cap * max_frags, pad] on the card for ``[n, cap]`` lanes,
    in one launch.

    ``p`` an int: ``p`` points, each input ``[p, n, cap]``, or ``[n, cap]``
    where every point shares it (a stride of 0);
    uint8[p, n * cap * max_frags, pad]."""
    args = (kidx, version, vlen, carries_val)
    n, cap = kidx.shape[-2:]
    own = [a.dim() == 3 for a in args]
    dev = kidx.device
    if dev.type != "cuda":
        raise ValueError(f"reply_values: the kernel takes CUDA tensors, not "
                         f"{dev}")

    from repro_torch.kernels import LAUNCHES

    from . import kernel

    pts = 1 if p is None else p
    lanes, f = n * cap, max_frags
    if f < 1 or pad < 1:
        raise ValueError(f"reply_values: max_frags {f} and pad {pad} must "
                         f"be >= 1")
    if pts * lanes * f * pad >= MAX_BYTES:
        raise ValueError(f"reply_values: {pts} x {lanes} x {f} x {pad} "
                         f"bytes, at or over the kernel's {MAX_BYTES}")
    for name, a, dt, o in (("kidx", kidx, I32, own[0]),
                           ("version", version, I32, own[1]),
                           ("vlen", vlen, I32, own[2]),
                           ("carries_val", carries_val, torch.bool, own[3])):
        shp = (p, n, cap) if p is not None and o else (n, cap)
        if a.device != dev or a.dtype != dt or tuple(a.shape) != shp:
            raise ValueError(f"reply_values: {name} is {a.dtype}"
                             f"{tuple(a.shape)} on {a.device}; the kernel "
                             f"takes {dt}{shp} on {dev}")
    args = [a.contiguous() for a in args]
    strides = [lanes if o and p is not None else 0 for o in own]
    out_shape = (lanes * f, pad) if p is None else (p, lanes * f, pad)
    out = torch.empty(out_shape, dtype=torch.uint8, device=dev)
    if lanes == 0:
        return out
    ptrs = [x for a, s in zip(args, strides) for x in (a.data_ptr(), s)]
    kernel.launch(*ptrs, out.data_ptr(), pts, lanes, f, pad,
                  torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["reply_values"] += 1
    return out
