"""Bind the Hopper count-min kernel (``kernel.cu``).

Built by :mod:`repro_torch.kernels._build` into ``.torch_ext_build/`` at
first use; importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from .._build import MAX_SMEM_BYTES, KernelLibrary, check_smem

DEPTH = 5
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_BATCHED_ARGS = [_P, ctypes.c_longlong, _I] + _ARGS[1:]
LIB = KernelLibrary("cms", Path(__file__).with_name("kernel.cu"),
                    {"cms_batched_launch": _BATCHED_ARGS,
                     "cms_empty_launch": _ARGS})


THREADS = 512
UNIT_MAX = 8 * THREADS          # lanes listed at once, at most
ENTRY_WORDS = 2 + DEPTH         # lane, tile and five columns per listed lane
FIXED_WORDS = 8 * THREADS // 32 + 1


def unit_lanes(b: int, width: int) -> int:
    """Lanes one block lists at once (mirrors ``unit_lanes`` in
    ``kernel.cu``): the batch rounded up to whole passes of the block, at
    most 4,096, at most what shared memory holds beside the sketch, and at
    least one pass."""
    fit = (MAX_SMEM_BYTES // 4 - DEPTH * width - FIXED_WORDS) // ENTRY_WORDS
    want = min(max(-(-b // THREADS) * THREADS, THREADS), UNIT_MAX)
    return max(min(fit // THREADS * THREADS, want), THREADS)


def smem_bytes(width: int, b: int = 1) -> int:
    """Shared memory one block needs (mirrors ``smem_bytes`` in
    ``kernel.cu``): its whole [5, W] sketch and the list of the masked
    lanes of one unit."""
    return 4 * (DEPTH * width + ENTRY_WORDS * unit_lanes(b, width)
                + FIXED_WORDS)


def max_width() -> int:
    """The widest sketch one block takes."""
    return (MAX_SMEM_BYTES // 4 - ENTRY_WORDS * THREADS - FIXED_WORDS) \
        // DEPTH


def launch(idx: int, idx_stride: int, per: int, mask: int, counts_in: int,
           counts_out: int, est: int, n: int, b: int, width: int, tile: int,
           stream: int, empty: bool = False) -> None:
    """Launch one block of 512 threads per sketch on ``stream`` (device
    addresses of int32 ``mask[n, B]``, ``counts[n, 5, W]`` in and out and
    ``est[n, B]``): sketch ``s`` reads its row indices at ``idx + (s //
    per) * idx_stride`` (int32 ``idx[n // per, B, 5]``, ``idx_stride`` =
    5B; 0 shares one ``idx[B, 5]``).  ``empty`` launches a kernel that
    does nothing, with the same grid and shared memory, to time the launch
    floor."""
    check_smem(smem_bytes(width, b),
               f"cms kernel: a [{DEPTH}, {width}] sketch beside a list of "
               f"{THREADS} lanes (W must stay <= "
               f"{max_width()}; the sketch is not truncated)")
    rest = (_P(mask), _P(counts_in), _P(counts_out), _P(est), n, b, width,
            tile, _P(stream))
    if empty:
        LIB.call("cms_empty_launch", _P(idx), *rest)
    else:
        LIB.call("cms_batched_launch", _P(idx), idx_stride, per, *rest)
