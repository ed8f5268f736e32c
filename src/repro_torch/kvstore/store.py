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

from repro_torch.core.hashing import _M32, _mul32, hash128_bytes_np, to_u32


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


class ByteStore:
    """Byte-accurate variable-length KV store (host side, numpy)."""

    def __init__(self, key_pad: int = 64, value_pad: int = 1438,
                 capacity: int = 4096):
        self.key_pad = key_pad
        self.value_pad = value_pad
        self.keys = np.zeros((capacity, key_pad), np.uint8)
        self.klen = np.zeros(capacity, np.int32)
        self.vals = np.zeros((capacity, value_pad), np.uint8)
        self.vlen = np.zeros(capacity, np.int32)
        self.hkey = np.zeros((capacity, 4), np.uint32)
        self.version = np.zeros(capacity, np.int32)
        self.used = np.zeros(capacity, bool)
        self._index: dict[bytes, int] = {}

    def put(self, key: bytes, value: bytes) -> int:
        """Insert ``key`` into the first free slot, or overwrite its value
        and bump its version; returns the slot."""
        if len(key) > self.key_pad or len(value) > self.value_pad:
            raise ValueError("key/value exceeds pad")
        if key in self._index:
            i = self._index[key]
            self.vals[i] = 0
            self.vals[i, : len(value)] = np.frombuffer(value, np.uint8)
            self.vlen[i] = len(value)
            self.version[i] += 1
            return i
        free = np.flatnonzero(~self.used)
        if len(free) == 0:
            raise RuntimeError("store full")
        i = int(free[0])
        self.used[i] = True
        self.keys[i, : len(key)] = np.frombuffer(key, np.uint8)
        self.klen[i] = len(key)
        self.vals[i, : len(value)] = np.frombuffer(value, np.uint8)
        self.vlen[i] = len(value)
        self.hkey[i] = hash128_bytes_np(key)
        self.version[i] = 0
        self._index[key] = i
        return i

    def get(self, key: bytes) -> tuple[bytes, int] | None:
        i = self._index.get(key)
        if i is None:
            return None
        return bytes(self.vals[i, : self.vlen[i]]), int(self.version[i])

    def get_by_idx(self, i: int) -> tuple[bytes, bytes, int]:
        return (bytes(self.keys[i, : self.klen[i]]),
                bytes(self.vals[i, : self.vlen[i]]),
                int(self.version[i]))

    def __len__(self) -> int:
        return int(self.used.sum())
