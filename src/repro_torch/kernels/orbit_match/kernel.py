"""Bind the Hopper orbit_match kernel (``kernel.cu``).

Built by :mod:`repro_torch.kernels._build` into ``.torch_ext_build/`` at
first use; importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from .._build import KernelLibrary

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 9 + [_I, _I, _P]
LIB = KernelLibrary("orbit_match", Path(__file__).with_name("kernel.cu"),
                    {"orbit_match_launch": _ARGS,
                     "orbit_match_empty_launch": _ARGS})
CLUSTER_LANES = 8 * 1024   # lanes one pass of the largest launch covers
CHUNK = 4096               # entries per pass over the table (kChunk in
                           # kernel.cu)


def launch(hkey: int, table: int, occ: int, valid: int, mask: int | None,
           cidx: int, hit: int, vhit: int, pop: int, b: int, c: int,
           stream: int, empty: bool = False) -> None:
    """Launch on ``stream``: one block of one thread per lane up to 1,024
    lanes, else a cluster of up to 8 blocks of 1,024 (device addresses of
    int32 ``hkey[B, 4]``, ``table[C, 4]``, ``occ[C]``, ``valid[C]``,
    ``mask[B]`` (None: every lane counts), the outputs ``cidx``, ``hit``,
    ``vhit`` [B] and ``pop[C]``, each written whole).  ``empty`` launches a
    kernel that does nothing, with the same grid, cluster and shared
    memory, to time the floor."""
    fn = "orbit_match_empty_launch" if empty else "orbit_match_launch"
    LIB.call(fn, _P(hkey), _P(table), _P(occ), _P(valid), _P(mask),
             _P(cidx), _P(hit), _P(vhit), _P(pop), b, c, _P(stream))
