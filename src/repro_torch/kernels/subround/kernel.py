"""Bind the Hopper subround kernel (``kernel.cu``).

Built by :mod:`repro_torch.kernels._build` into ``.torch_ext_build/`` at
first use; importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from .._build import MAX_SMEM_BYTES, KernelLibrary, check_smem

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BATCHED_ARGS = _ARGS[:1] + [ctypes.c_void_p, ctypes.c_int] + _ARGS[1:]
LIB = KernelLibrary("subround", Path(__file__).with_name("kernel.cu"),
                    {"subround_batched_launch": _BATCHED_ARGS,
                     "subround_empty_launch": _ARGS})


WARPS = 16           # kThreads / 32 in kernel.cu


def smem_bytes(b: int, c: int, s: int, f: int) -> int:
    """Shared memory one launch needs (mirrors ``smem_bytes`` in
    ``kernel.cu``): the hash table padded to whole 16-byte groups of
    entries, 14 words per entry, 5 per line, 7 per slot, one admission
    count per warp and entry, one word per lane and the live-line
    count."""
    c4 = (c + 3) // 4 * 4
    return 4 * (5 * c4 + c * (14 + 5 * f + 7 * s + WARPS) + b + 1)


def launch(ptrs: list[int], strides: list[int], p: int, b: int, c: int,
           s: int, f: int, j: int, stream: int, empty: bool = False) -> None:
    """Launch ``p`` switch instances, one block of 512 threads each, on
    ``stream``: ``ptrs`` are point 0's 31 input and 32 output device
    addresses, ``strides`` the 63 per-point strides in elements (0 for an
    input the points share).  Raises if the launch is refused.  ``empty``
    launches one block of a kernel that does nothing, with the same
    parameters and shared memory, to time the launch floor."""
    check_smem(smem_bytes(b, c, s, f),
               f"subround kernel: B={b}, C={c}, S={s}, F={f} (5*C4 + "
               f"C*(30+5F+7S) + B + 1 words, C4 = C rounded up to a "
               f"multiple of 4, must stay <= {MAX_SMEM_BYTES // 4})")
    arr = (ctypes.c_uint64 * len(ptrs))(*ptrs)
    if empty:
        LIB.call("subround_empty_launch", arr, b, c, s, f, j,
                 ctypes.c_void_p(stream))
        return
    st = (ctypes.c_int * len(strides))(*strides)
    LIB.call("subround_batched_launch", arr, st, p, b, c, s, f, j,
             ctypes.c_void_p(stream))
