"""Logical-axis sharding rules (DP / TP / EP / SP / ZeRO) over a
``torch.distributed`` device mesh (port of ``repro.parallel.sharding``).

Tensors are annotated with *logical* axis names; a rule table maps each to
mesh axes.  The production mesh is ``('data','model')`` single-pod or
``('pod','data','model')`` multi-pod; the rules keep every sharding
expressible for both by treating "dp" as ``('pod','data')`` when the pod
axis exists.

Logical axes used by the model stack:

  batch      data-parallel batch                   -> (pod,) data
  seq        sequence (SP for long prefill)        -> None (or model for SP)
  vocab      embedding/logit vocabulary            -> model
  heads      attention query heads                 -> model
  kv_heads   KV heads (sharded iff divisible)      -> model | None
  d_ff       MLP hidden                            -> model
  experts    MoE experts (EP iff divisible)        -> model | None
  d_model    residual stream                       -> None (replicated)
  zero       optimizer-state / master-param shard  -> (pod, data, model) flat

A spec is the port's own :class:`PartitionSpec` (one entry per tensor
dim: ``None``, a mesh axis name or a tuple of them).  :func:`placements`
turns it into DTensor placements, one per mesh dimension, and
:func:`with_sharding` redistributes a DTensor to it, the counterpart of
``lax.with_sharding_constraint``.  A :class:`ShardingCtx` holds either a
``DeviceMesh`` or, for shape-only work such as the spec tables, a plain
mapping of axis name to size (the reference's ``AbstractMesh``).

The reference's ``shard_map_compat`` and ``axis_size_compat`` are
jax-version shims and have no counterpart; the ring's collectives are
``core/distributed.py``'s.
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass
from typing import Any, Optional

import torch


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of names (the dim split over those axes, major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class AxisRules:
    data_axes: tuple[str, ...]        # ('data',) or ('pod', 'data')
    model_axis: str = "model"
    # Megatron-style sequence parallelism: the inter-layer residual stream
    # shards its sequence dim over the model axis.
    seq_axis: Optional[str] = None

    @property
    def dp(self):
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or a shape-only mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclass
class ShardingCtx:
    mesh: Any          # DeviceMesh, or Mapping[str, int] (shape only)
    rules: AxisRules

    @property
    def shape(self) -> dict[str, int]:
        return mesh_shape(self.mesh)

    @property
    def model_size(self) -> int:
        return self.shape[self.rules.model_axis]

    @property
    def data_size(self) -> int:
        n = 1
        for a in self.rules.data_axes:
            n *= self.shape[a]
        return n

    def spec(self, *logical_axes: Optional[str], **kw) -> PartitionSpec:
        return logical(self.rules, *logical_axes, **kw)

    def placements(self, *logical_axes: Optional[str]):
        return placements(self.spec(*logical_axes), self.mesh)

    def divisible(self, n: int) -> bool:
        return n % self.model_size == 0


def logical(rules: AxisRules, *axes: Optional[str],
            divisible=None) -> PartitionSpec:
    """Map logical axis names to a PartitionSpec under ``rules``."""
    out: list[Any] = []
    for a in axes:
        if a is None or a in ("d_model", "state"):
            out.append(None)
        elif a == "seq":
            out.append(rules.seq_axis)
        elif a == "batch":
            out.append(rules.dp)
        elif a in ("vocab", "heads", "d_ff", "experts", "kv_heads", "head_dim"):
            out.append(rules.model_axis)
        elif a == "zero":
            out.append(tuple(rules.data_axes) + (rules.model_axis,))
        else:
            raise ValueError(f"unknown logical axis {a!r}")
    return PartitionSpec(*out)


def make_ctx(mesh, sequence_parallel: bool = False) -> ShardingCtx:
    names = tuple(mesh_shape(mesh))
    data_axes = tuple(a for a in names if a in ("pod", "data"))
    return ShardingCtx(mesh=mesh, rules=AxisRules(
        data_axes=data_axes,
        seq_axis="model" if sequence_parallel else None))


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dimension:
    ``Shard(d)`` where the mesh axis appears in entry ``d``, ``Replicate()``
    elsewhere.  A tuple entry splits its dim over its axes major first
    (JAX's order), which DTensor's default nesting gives when the axes
    come in mesh order; another order raises.  A mesh axis of size 1
    holds every dim whole, so it gets ``Replicate()`` (the same layout;
    torch 2.11's DTensor refuses to flatten two dims when the second is
    sharded, even over one rank, as attention's einsum does)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_shape(mesh)
    names = list(sizes)
    out: list[Any] = [Replicate()] * len(names)
    used: set = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for i in idx:
            if i in used:
                raise ValueError(f"mesh axis {names[i]!r} used twice in "
                                 f"{spec!r}")
            used.add(i)
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def distribute(tree, specs, mesh):
    """DTensors of ``tree``'s leaves in ``specs``' layouts (same
    structure: dicts, lists, tuples, NamedTuples)."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: distribute(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [distribute(v, s, mesh) for v, s in zip(tree, specs)]
    if isinstance(tree, tuple) and not isinstance(specs, P):
        items = [distribute(v, s, mesh) for v, s in zip(tree, specs)]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return distribute_tensor(tree, mesh, placements(specs, mesh))


def distribute_parameters(model, specs: dict, mesh):
    """Replace each of ``model``'s parameters, in place, by a DTensor
    parameter in its spec's layout."""
    from torch.distributed.tensor import distribute_tensor

    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        setattr(mod, leaf, torch.nn.Parameter(
            distribute_tensor(p.detach(), mesh,
                              placements(specs[name], mesh)),
            requires_grad=p.requires_grad))
    return model


def with_sharding(ctx: Optional[ShardingCtx], x, *axes: Optional[str]):
    """Redistribute a DTensor ``x`` to the logical ``axes`` on ``ctx``'s
    mesh; the identity without a context or on a plain tensor."""
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(ctx.mesh, ctx.placements(*axes))
