"""Bind the Hopper server_enqueue kernel (``kernel.cu``).

Built by :mod:`repro_torch.kernels._build` into ``.torch_ext_build/`` at
first use; importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from .._build import KernelLibrary

N_IN, N_OUT = 20, 13
_A, _P, _I = ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p, ctypes.c_int
_ARGS = [_A, _A, _A, _I, _I, _I, _I, _P]
LIB = KernelLibrary("server_enqueue", Path(__file__).with_name("kernel.cu"),
                    {"server_enqueue_batched_launch": _ARGS,
                     "server_enqueue_empty_launch": _ARGS})


def launch(ins: list[int], strides: list[int], outs: list[int], p: int,
           lanes: int, n: int, q: int, stream: int,
           empty: bool = False) -> None:
    """Launch on ``stream``: ``p`` points of ``lanes`` lanes and ``n``
    servers with rings of ``q`` slots.  ``ins``: device addresses of point
    0's 20 inputs (``kernel.cu`` gives their order), each with its
    per-point stride in elements in ``strides`` (0 for one the points
    share); ``outs``: the 13 outputs' addresses, each ``[p, ...]``, written
    whole.  ``empty`` launches a kernel that does nothing, with the same
    grid, to time the launch floor."""
    arr = lambda xs, k: (ctypes.c_longlong * k)(*xs)  # noqa: E731
    fn = ("server_enqueue_empty_launch" if empty
          else "server_enqueue_batched_launch")
    LIB.call(fn, arr(ins, N_IN), arr(strides, N_IN), arr(outs, N_OUT), p,
             lanes, n, q, _P(stream))
