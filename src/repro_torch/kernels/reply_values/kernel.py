"""Bind the Hopper reply_values kernel (``kernel.cu``).

Built by :mod:`repro_torch.kernels._build` into ``.torch_ext_build/`` at
first use; importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from .._build import KernelLibrary

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P, _L, _P, _L, _P, _L, _P, _L, _P, _I, _I, _I, _I, _P]
LIB = KernelLibrary("reply_values", Path(__file__).with_name("kernel.cu"),
                    {"reply_values_launch": _ARGS,
                     "reply_values_empty_launch": _ARGS})


def launch(kidx: int, s_kidx: int, version: int, s_version: int, vlen: int,
           s_vlen: int, carries: int, s_carries: int, out: int, p: int,
           lanes: int, f: int, pad: int, stream: int,
           empty: bool = False) -> None:
    """Launch on ``stream``: ``p`` points of ``lanes`` lanes (device
    addresses of point 0's int32 ``kidx``, ``version``, ``vlen`` and bool
    ``carries`` [lanes], each with its per-point stride in elements, 0 for
    one the points share), ``out`` uint8[p, lanes * f, pad] written whole.
    ``empty`` launches a kernel that does nothing, with the same grid, to
    time the launch floor."""
    fn = "reply_values_empty_launch" if empty else "reply_values_launch"
    LIB.call(fn, _P(kidx), s_kidx, _P(version), s_version, _P(vlen), s_vlen,
             _P(carries), s_carries, _P(out), p, lanes, f, pad, _P(stream))
