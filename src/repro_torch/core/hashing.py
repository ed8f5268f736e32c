"""128-bit key hashing (port of ``repro.core.hashing``).

Torch cannot shift uint32 tensors, so the 32-bit arithmetic runs in int64
masked to 32 bits, and every 32x32-bit multiply is split into two 16-bit
halves so no intermediate leaves the int64 range.  Hash words leave as
int32 tensors holding the reference's uint32 bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from .types import device_const

_M32 = 0xFFFFFFFF
_FNV_PRIME = 16777619
_LANE_BASIS = (2166136261, 2166136261 ^ 0x5BD1E995,
               2166136261 ^ 0x9E3779B9, 2166136261 ^ 0x85EBCA6B)
_SM1, _SM2 = 0x7FEB352D, 0x846CA68B


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) held in int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int64 holding its low 32 bits as unsigned."""
    return x.to(torch.int64) & _M32


def as_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) -> int32 with the same bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _splitmix32(x: torch.Tensor) -> torch.Tensor:
    """SplitMix32 finalizer on int64 tensors holding uint32 values."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, _SM1)
    x = x ^ (x >> 15)
    x = _mul32(x, _SM2)
    return x ^ (x >> 16)


def _splitmix32_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(_SM1)).astype(np.uint32)
    x ^= x >> np.uint32(15)
    x = (x * np.uint32(_SM2)).astype(np.uint32)
    x ^= x >> np.uint32(16)
    return x


def hash128_bytes_np(key: bytes | np.ndarray) -> np.ndarray:
    """Hash variable-length key bytes -> uint32[4] (128 bits): the FNV
    lanes over every byte, then the SplitMix32 finalizer."""
    data = (np.frombuffer(bytes(key), dtype=np.uint8)
            if isinstance(key, (bytes, bytearray))
            else np.asarray(key, np.uint8))
    lanes = np.asarray(_LANE_BASIS, np.uint32)
    for b in data:
        lanes = ((lanes ^ np.uint32(b)) * np.uint32(_FNV_PRIME)
                 ).astype(np.uint32)
    return _splitmix32_np(lanes)


def hash128_u32(kidx: torch.Tensor) -> torch.Tensor:
    """int[...] key identities -> int32[..., 4] hash words (uint32 bits)."""
    k = to_u32(kidx)
    lanes = device_const(_LANE_BASIS, torch.int64, k.device).expand(
        k.shape + (4,))
    for i in range(4):
        byte = ((k >> (8 * i)) & 0xFF)[..., None]
        lanes = _mul32(lanes ^ byte, _FNV_PRIME)
    return as_i32_bits(_splitmix32(lanes))


def hash128_u32_np(kidx: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`hash128_u32`, returning uint32[..., 4]."""
    k = np.asarray(kidx).astype(np.uint32)
    lanes = np.broadcast_to(np.asarray(_LANE_BASIS, np.uint32),
                            k.shape + (4,)).copy()
    for i in range(4):
        byte = ((k >> np.uint32(8 * i)) & np.uint32(0xFF)).astype(np.uint32)
        lanes = ((lanes ^ byte[..., None]) * np.uint32(_FNV_PRIME)
                 ).astype(np.uint32)
    return _splitmix32_np(lanes)


def fold_hash(hkey: torch.Tensor, width: int, salt: int = 0) -> torch.Tensor:
    """Fold int32[..., 4] hash words into an index in ``[0, width)``:
    int32[...].  Logical shifts and an unsigned ``%`` on the uint32 words,
    as the reference's uint32 arithmetic does."""
    salt32 = (salt * 0x9E3779B9 + 0x85EBCA6B) & _M32
    w = to_u32(hkey)
    h = _splitmix32(w[..., 0] ^ salt32)
    h = h ^ w[..., 1] ^ (w[..., 2] >> 7) ^ ((w[..., 3] << 3) & _M32)
    return (_splitmix32(h) % width).to(torch.int32)


def server_of_key(kidx: torch.Tensor, num_servers: int) -> torch.Tensor:
    """Hash-partition owner of a key: int32[...]."""
    h = _splitmix32(to_u32(kidx) ^ 0xCAFE01)
    return (h % num_servers).to(torch.int32)


def server_of_key_np(kidx: np.ndarray, num_servers: int) -> np.ndarray:
    """Numpy twin of :func:`server_of_key`: int32[...]."""
    x = np.asarray(kidx).astype(np.uint32) ^ np.uint32(0xCAFE01)
    return (_splitmix32_np(x) % np.uint32(num_servers)).astype(np.int32)
