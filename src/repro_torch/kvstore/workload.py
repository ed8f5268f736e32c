"""Key-value workload (port of ``repro.kvstore.workload``).

Zipf popularity over rank-ordered keys, a rank -> key permutation and a
per-key value size.  The CDF is a float64 cumulative sum cast to float32
and the size classes come from the same hash draw as the reference, so
both packages sample the same keys from the same uniforms.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.hashing import hash128_u32_np
from repro_torch.core.types import resolve_device


class WorkloadArrays(NamedTuple):
    cdf: torch.Tensor   # float32[num_keys] Zipf CDF over popularity ranks
    perm: torch.Tensor  # int32[num_keys] rank -> key identity
    vlen: torch.Tensor  # int32[num_keys] per-key value bytes


@dataclass(frozen=True)
class WorkloadConfig:
    num_keys: int = 1_000_000
    zipf_alpha: float = 0.99
    key_size: int = 16
    value_sizes: tuple[tuple[int, float], ...] = ((64, 0.82), (1024, 0.18))
    write_ratio: float = 0.0
    offered_rps: float = 4.0e6
    seed: int = 0
    value_seed: int = 5


# Paper Fig. 14: Twitter-derived workloads A–E = Cluster045/016/044/017/020,
# characterized by (fraction of small 64-B values = NetCache-cacheable ratio,
# write ratio).
PRODUCTION_WORKLOADS: dict[str, dict] = {
    "A": dict(small_frac=0.95, write_ratio=0.20),   # Cluster045
    "B": dict(small_frac=0.70, write_ratio=0.05),   # Cluster016
    "C": dict(small_frac=0.50, write_ratio=0.10),   # Cluster044
    "D": dict(small_frac=0.25, write_ratio=0.02),   # Cluster017
    "E": dict(small_frac=0.01, write_ratio=0.01),   # Cluster020
}


def production_workload(name: str,
                        base: WorkloadConfig | None = None) -> WorkloadConfig:
    """``base`` (default ``WorkloadConfig()``) with workload ``name``'s
    value-size split (64 B and 1024 B) and write ratio."""
    base = base or WorkloadConfig()
    p = PRODUCTION_WORKLOADS[name]
    sf = p["small_frac"]
    return replace(base, value_sizes=((64, sf), (1024, 1.0 - sf)),
                   write_ratio=p["write_ratio"])


class Workload:
    """Materialized workload: Zipf CDF + per-key value sizes + rank perm,
    built in numpy and held on ``device``."""

    def __init__(self, cfg: WorkloadConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        n = cfg.num_keys
        ranks = np.arange(1, n + 1, dtype=np.float64)
        w = ranks ** (-cfg.zipf_alpha)
        self.probs = w / w.sum()
        cdf = np.cumsum(self.probs).astype(np.float32)
        self._perm_np = np.arange(n, dtype=np.int32)
        h = hash128_u32_np(
            ((np.arange(n, dtype=np.int64) + cfg.value_seed * 1_000_003)
             .astype(np.int32)))[:, 0]
        u = h.astype(np.float64) / 2**32
        sizes = np.zeros(n, np.int32)
        lo = 0.0
        for size, frac in cfg.value_sizes:
            hi = lo + frac
            sizes[(u >= lo) & (u < hi)] = size
            lo = hi
        sizes[sizes == 0] = cfg.value_sizes[-1][0]
        self.vlen_np = sizes
        dev = self.device
        self.cdf = torch.from_numpy(cdf).to(dev)
        self.perm = torch.from_numpy(self._perm_np.copy()).to(dev)
        self.vlen = torch.from_numpy(sizes).to(dev)

    @property
    def arrays(self) -> WorkloadArrays:
        return WorkloadArrays(cdf=self.cdf, perm=self.perm, vlen=self.vlen)

    def hot_in_swap(self, n_hot: int = 128) -> None:
        """Swap the ``n_hot`` hottest ranks with the ``n_hot`` coldest
        (paper §5.3 churn); ``perm`` is rebuilt on the workload's device."""
        p = self._perm_np
        hot = p[:n_hot].copy()
        p[:n_hot] = p[-n_hot:]
        p[-n_hot:] = hot
        self.perm = torch.from_numpy(p.copy()).to(self.device)

    def hottest_keys(self, k: int) -> np.ndarray:
        return self._perm_np[:k].copy()

    def head_coverage(self, k: int) -> float:
        """Fraction of requests served by the k hottest keys."""
        return float(self.probs[:k].sum())
