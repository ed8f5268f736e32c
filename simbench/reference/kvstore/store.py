"""Key-value storage (port of ``repro.kvstore.store``).

* ``ByteStore``: a byte-accurate host store for tests and small systems:
  variable-length keys and values in padded uint8 arrays, with insert /
  get / update, plus each key's 128-bit hash (the shim layer's HKEY).
* ``synth_value`` (and its numpy twin ``synth_value_np``): deterministic
  value bytes of ``(key, version)``, so a 10M-key store needs no value
  memory and a stale value is detectable by its content.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.hashing import _M32, _mul32, to_u32


def synth_value(kidx: torch.Tensor, version: torch.Tensor, width: int,
                offset: torch.Tensor | int = 0) -> torch.Tensor:
    """uint8[..., width] bytes of (key, version):

    byte[i] = splitmix32(kidx * P1 ^ version * P2 ^ (offset + i)) & 0xFF

    ``offset`` (broadcastable to ``kidx``) selects a byte window, for the
    fragments of multi-packet values.
    """
    dev = kidx.device
    k = to_u32(kidx)[..., None]
    v = to_u32(version)[..., None]
    off = (to_u32(torch.as_tensor(offset, device=dev))[..., None]
           if isinstance(offset, torch.Tensor) else offset)
    i = (torch.arange(width, dtype=torch.int64, device=dev) + off) & _M32
    x = _mul32(k, 0x9E3779B9) ^ _mul32(v, 0x85EBCA6B) ^ i
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x & 0xFF).to(torch.uint8)


def synth_value_np(kidx, version, width: int) -> np.ndarray:
    """Numpy twin of :func:`synth_value` for one key: uint8[width]."""
    k = np.uint32((int(kidx) * 0x9E3779B9) & 0xFFFFFFFF)
    v = np.uint32((int(version) * 0x85EBCA6B) & 0xFFFFFFFF)
    i = np.arange(width, dtype=np.uint32)
    with np.errstate(over="ignore"):
        x = (k ^ v ^ i).astype(np.uint32)
        x ^= x >> np.uint32(16)
        x = (x * np.uint32(0x7FEB352D)).astype(np.uint32)
        x ^= x >> np.uint32(15)
        x = (x * np.uint32(0x846CA68B)).astype(np.uint32)
        x ^= x >> np.uint32(16)
    return (x & np.uint32(0xFF)).astype(np.uint8)
