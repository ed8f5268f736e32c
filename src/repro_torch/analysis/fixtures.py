"""Seeded-violation fixtures: deliberately broken bodies, each beside its
clean twin (port of ``repro.analysis.fixtures``).

``tests/test_torch_lint.py`` runs every rule against these to prove the
rules FIRE (and that the clean twin passes), so the linter cannot rot into
a no-op while the tree stays green.  Nothing here is production code; the
violations are the footguns the rules exist to catch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import kernels as kn
from repro_torch.core.types import COUNTER_DTYPE, sat_add

from .entry_points import EntryPoint, Harness


# --- no-scatter: a per-lane scatter in a loop body --------------------------
def scatterful_loop(xs):
    acc = xs.clone()
    lanes = torch.arange(xs.shape[0], device=xs.device)
    for i in range(4):
        acc.scatter_(0, lanes[i:i + 1], xs[i:i + 1] * 2)   # per-lane scatter
    return acc


def scatter_free_loop(xs):
    acc = xs.clone()
    lanes = torch.arange(xs.shape[0], device=xs.device)
    for i in range(4):
        acc = torch.where(lanes == i, xs * 2, acc)         # one-hot algebra
    return acc


# --- no-host-sync: a data-dependent Python branch in a body -----------------
def host_branch(xs):
    if (xs > 0).any():                     # waits for the device
        xs = xs - 1
    return xs


def device_select(xs):
    return torch.where(xs > 0, xs - 1, xs)


# --- counter-saturation: a plain + into a counter ---------------------------
class CounterCarry(NamedTuple):
    hits: torch.Tensor      # int64[4] (uint32 values)
    lanes: torch.Tensor     # int32[4]


def plain_add_counter(carry: CounterCarry) -> CounterCarry:
    return carry._replace(hits=carry.hits + 2)     # passes 2**32 - 1


def saturating_counter(carry: CounterCarry) -> CounterCarry:
    return carry._replace(hits=sat_add(carry.hits, 2))


# --- kernel-launches: a path that claims a kernel and calls none ------------
def dense_hot_gather(ids, hot_ids, rows):
    return (ids[:, None] == hot_ids[None, :]).to(rows.dtype) @ rows


def kernel_hot_gather(ids, hot_ids, rows):
    return kn.hot_gather(ids, hot_ids, rows)[0]


# --- carry-in-place: a chunk that rebinds its carry -------------------------
class RebindingChunk:
    """Each run makes new carry tensors (the reference's undonated chunk)."""

    def __init__(self, device):
        self.carry = (torch.zeros(4, device=device),
                      torch.zeros(4, dtype=torch.int32, device=device))

    def run(self):
        self.carry = tuple(t + 1 for t in self.carry)


class InPlaceChunk(RebindingChunk):
    """Each run copies the new carry into the buffers it owns."""

    def run(self):
        for t in self.carry:
            t.copy_(t + 1)


# --- recapture-guard: a capture cache keyed by the swept value --------------
class ValueKeyedCache:
    """A stand-in for a chunk's graph cache that keys its captures by the
    swept value, so every sweep point captures anew."""

    def __init__(self, device):
        self.x = torch.ones(4, device=device)
        self.value = 1.0
        self.captures = 0
        self._graphs: dict = {}

    def key(self):
        return self.value

    def run(self):
        if self.key() not in self._graphs:
            self._graphs[self.key()] = self.captures
            self.captures += 1
        self.x.mul_(self.value)


class ShapeKeyedCache(ValueKeyedCache):
    """Keys its captures by shape only; the value is copied in."""

    def key(self):
        return tuple(self.x.shape)


# --- EntryPoint wrappers -----------------------------------------------------
def _tensor(device, kind="f"):
    if kind == "f":
        return torch.tensor([-1.0, 2.0, 0.5, 3.0], device=device)
    return torch.arange(4, dtype=torch.int32, device=device)


def op_entry(name: str, fn, device="cpu") -> EntryPoint:
    """``fn`` of one float32[4] as a one-body entry."""
    def build(dev, graphs):
        x = _tensor(dev)
        return Harness(run=lambda: fn(x))
    return EntryPoint(f"fixture.{name}", build, {}, torch.device(device),
                      body_fn=fn)


def counter_entry(name: str, step, device="cpu") -> EntryPoint:
    def build(dev, graphs):
        carry = lambda: CounterCarry(
            hits=torch.zeros(4, dtype=COUNTER_DTYPE, device=dev),
            lanes=_tensor(dev, "i"))
        return Harness(run=lambda: step(carry()), step=step, carry=carry)
    return EntryPoint(f"fixture.{name}", build, {}, torch.device(device),
                      body_fn=step)


def launch_entry(name: str, fn, device="cpu") -> EntryPoint:
    """``fn`` over one hot-gather input set, claiming ONE ``hot_gather``."""
    def build(dev, graphs):
        ids = torch.tensor([3, 1, 4, 1], dtype=torch.int32, device=dev)
        hot = torch.tensor([1, 3], dtype=torch.int32, device=dev)
        rows = torch.ones((2, 2), device=dev)
        return Harness(run=lambda: fn(ids, hot, rows))
    return EntryPoint(f"fixture.{name}", build, dict(hot_gather=1),
                      torch.device(device), body_fn=fn)


def chunk_entry(name: str, cls, device="cpu") -> EntryPoint:
    def build(dev, graphs):
        chunk = cls(dev)
        return Harness(run=chunk.run, chunk=chunk, state=lambda: chunk.carry)
    return EntryPoint(f"fixture.{name}", build, {}, torch.device(device),
                      body_fn=cls.run)


def recapture_entry(name: str, cls, device="cpu") -> EntryPoint:
    def build(dev, graphs):
        cache = cls(dev)
        return Harness(run=cache.run, chunk=cache,
                       sweep=lambda v: setattr(cache, "value", v))
    return EntryPoint(f"fixture.{name}", build, {}, torch.device(device),
                      axis="value", sweep_values=(3.0, 0.5),
                      body_fn=cls.key)


def cases(device="cpu") -> dict:
    """Every rule's fixtures on ``device``: ``rule -> (violation, clean
    twin, the op its findings name, the function their site names)``."""
    d = device
    return {
        "no-scatter": (op_entry("scatter", scatterful_loop, d),
                       op_entry("one_hot", scatter_free_loop, d),
                       "aten.scatter_.src", "scatterful_loop"),
        "no-host-sync": (op_entry("branch", host_branch, d),
                         op_entry("select", device_select, d),
                         "aten._local_scalar_dense.default", "host_branch"),
        "counter-saturation": (
            counter_entry("plain_add", plain_add_counter, d),
            counter_entry("sat_add", saturating_counter, d),
            "", "plain_add_counter"),
        "kernel-launches": (launch_entry("dense", dense_hot_gather, d),
                            launch_entry("kernel", kernel_hot_gather, d),
                            "hot_gather", "dense_hot_gather"),
        "carry-in-place": (chunk_entry("rebind", RebindingChunk, d),
                           chunk_entry("copy", InPlaceChunk, d),
                           "", "RebindingChunk.run"),
        "recapture-guard": (
            recapture_entry("by_value", ValueKeyedCache, d),
            recapture_entry("by_shape", ShapeKeyedCache, d),
            "", "ValueKeyedCache.key"),
    }
