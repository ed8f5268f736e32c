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
LIB = KernelLibrary("cms", Path(__file__).with_name("kernel.cu"),
                    {"cms_launch": _ARGS, "cms_empty_launch": _ARGS})


def smem_bytes(width: int) -> int:
    """Shared memory one block needs: its whole [5, W] sketch."""
    return 4 * DEPTH * width


def launch(idx: int, mask: int, counts_in: int, counts_out: int, est: int,
           n: int, b: int, width: int, tile: int, stream: int,
           empty: bool = False) -> None:
    """Launch one block per sketch on ``stream`` (device addresses of
    int32 ``idx[B, 5]``, ``mask[n, B]``, ``counts[n, 5, W]`` in and out and
    ``est[n, B]``).  ``empty`` launches a kernel that does nothing, with
    the same grid and shared memory, to time the launch floor."""
    check_smem(smem_bytes(width),
               f"cms kernel: a [{DEPTH}, {width}] sketch (W must stay <= "
               f"{MAX_SMEM_BYTES // (4 * DEPTH)}; the sketch is not "
               f"truncated)")
    fn = "cms_empty_launch" if empty else "cms_launch"
    LIB.call(fn, _P(idx), _P(mask), _P(counts_in), _P(counts_out), _P(est),
             n, b, width, tile, _P(stream))
