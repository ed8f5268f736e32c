"""Bind the Hopper orbit_match kernel (``kernel.cu``).

Built by :mod:`repro_torch.kernels._build` into ``.torch_ext_build/`` at
first use; importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from .._build import MAX_SMEM_BYTES, KernelLibrary, check_smem

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 9 + [_I, _I, _P]
LIB = KernelLibrary("orbit_match", Path(__file__).with_name("kernel.cu"),
                    {"orbit_match_launch": _ARGS,
                     "orbit_match_empty_launch": _ARGS})
ENTRY_BYTES = 28     # four hash words, two flags and a count per entry


def smem_bytes(c: int) -> int:
    """Shared memory one block needs: the staged table and its counts."""
    return ENTRY_BYTES * c


def launch(hkey: int, table: int, occ: int, valid: int, mask: int | None,
           cidx: int, hit: int, vhit: int, pop: int, b: int, c: int,
           stream: int, empty: bool = False) -> None:
    """Zero ``pop`` and launch one thread per lane on ``stream`` (device
    addresses of int32 ``hkey[B, 4]``, ``table[C, 4]``, ``occ[C]``,
    ``valid[C]``, ``mask[B]`` (None: every lane counts), the outputs
    ``cidx``, ``hit``, ``vhit`` [B] and ``pop[C]``).  ``empty`` launches a
    kernel that does nothing, with the same zeroing, grid and shared
    memory, to time the launch floor."""
    check_smem(smem_bytes(c),
               f"orbit_match kernel: a table of {c} entries (C must stay <= "
               f"{MAX_SMEM_BYTES // ENTRY_BYTES})")
    fn = "orbit_match_empty_launch" if empty else "orbit_match_launch"
    LIB.call(fn, _P(hkey), _P(table), _P(occ), _P(valid), _P(mask),
             _P(cidx), _P(hit), _P(vhit), _P(pop), b, c, _P(stream))
