"""Bind the Hopper hot_gather kernel (``kernel.cu``).

Built by :mod:`repro_torch.kernels._build` into ``.torch_ext_build/`` at
first use; importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import KernelLibrary

_P, _I = ctypes.c_void_p, ctypes.c_int
_L = ctypes.c_longlong
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_BATCHED_ARGS = [_P, _L, _P, _L, _P, _L, _P, _P, _I, _I, _I, _I, _I, _P]
LIB = KernelLibrary("hot_gather", Path(__file__).with_name("kernel.cu"),
                    {"hot_gather_batched_launch": _BATCHED_ARGS,
                     "hot_gather_empty_launch": _ARGS})
# row types the kernel takes, by the code kernel.cu switches on
DTYPES = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}
CHUNK = 4096         # hot ids per shared-memory table (kChunk in kernel.cu)


def launch(ids: int, s_ids: int, hot: int, s_hot: int, rows: int,
           s_rows: int, out: int, hit: int, p: int, b: int, c: int, d: int,
           dtype: torch.dtype, stream: int, empty: bool = False) -> None:
    """Launch ``p`` points on ``stream`` (grid z = P): point 0's device
    addresses of int32 ``ids[B]`` and ``hot[C]`` and ``rows[C, D]`` of
    ``dtype``, each with its per-point stride in elements (0 for one the
    points share), ``out[P, B, D]`` and int32 ``hit[P, B]`` stacked.
    ``empty`` launches one point of a kernel that does nothing, with the
    same grid and shared memory, to time the launch floor."""
    if empty:
        LIB.call("hot_gather_empty_launch", _P(ids), _P(hot), _P(rows),
                 _P(out), _P(hit), b, c, d, DTYPES[dtype], _P(stream))
        return
    LIB.call("hot_gather_batched_launch", _P(ids), s_ids, _P(hot), s_hot,
             _P(rows), s_rows, _P(out), _P(hit), p, b, c, d, DTYPES[dtype],
             _P(stream))
