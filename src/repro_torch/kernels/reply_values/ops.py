"""Wrapper for the reply_values kernel.

On CUDA tensors it launches the Hopper kernel (``kernel.cu``); on CPU
tensors it runs the plain version (``ref.reply_values_ref``).  Inputs are
a server step's ``[n, cap]`` lanes: int32 ``kidx``, ``version`` and
``vlen`` and bool ``carries_val``; the output is uint8[n * cap * F, pad].
"""
from __future__ import annotations

import torch

from . import ref

I32 = torch.int32
MAX_BYTES = 2**31     # the kernel indexes its output in uint32


def reply_values(kidx, version, vlen, carries_val, max_frags: int,
                 pad: int):
    """uint8[n * cap * max_frags, pad] for ``[n, cap]`` lanes."""
    return reply_values_batched(kidx, version, vlen, carries_val, None,
                                max_frags, pad)


def reply_values_batched(kidx, version, vlen, carries_val, p: int | None,
                         max_frags: int, pad: int):
    """``p`` points in one call: each input ``[p, n, cap]``, or ``[n, cap]``
    when every point shares it (at least one input has the axis);
    uint8[p, n * cap * max_frags, pad].  ``p`` None: one rack, every input
    ``[n, cap]``, no point axis on the output.

    On CUDA tensors one launch; on CPU tensors the plain version once."""
    args = (kidx, version, vlen, carries_val)
    n, cap = kidx.shape[-2:]
    own = [a.dim() == 3 for a in args]
    dev = kidx.device
    if dev.type == "cpu":
        return ref.reply_values_ref(*args, max_frags, pad)
    if dev.type != "cuda":
        raise ValueError(f"reply_values: no kernel for device {dev}")

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
