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
    structure: dicts, lists, tuples, NamedTuples).  A dict of per-layer
    parameter leaves whose specs name a stacked leaf is stacked first
    (``interop.lm_stack``)."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        if set(tree) != set(specs):
            from repro_torch import interop
            tree = interop.lm_stack(tree, specs)
        return {k: distribute(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [distribute(v, s, mesh) for v, s in zip(tree, specs)]
    if isinstance(tree, tuple) and not isinstance(specs, P):
        items = [distribute(v, s, mesh) for v, s in zip(tree, specs)]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return distribute_tensor(tree, mesh, placements(specs, mesh))


def _layer_slice(leaf: str):
    """A property reading ``leaf`` as its layer's slice of a stacked
    parameter (``module._stacked_slices[leaf] = (holder, name, index)``),
    taken at each use: a DTensor sharded on its layer axes is gathered on
    them first, as XLA gathers a scanned leaf's layer inside its loop."""
    def get(self):
        from torch.distributed.tensor import DTensor, Replicate

        holder, name, idx = self._stacked_slices[leaf]
        t = getattr(holder, name)
        if isinstance(t, DTensor):
            t = t.redistribute(t.device_mesh, [
                Replicate() if p.is_shard() and p.dim < len(idx) else p
                for p in t.placements])
        return t[idx]
    return property(get)


def stack_parameters(model, names) -> None:
    """Hold each stacked name of ``names`` (``interop.STACKED``) as one
    parameter of ``model``, in place: the per-layer leaves stacked on the
    reference's leading axes, registered under the name (on holder
    modules below ``model.stacked``), and each layer's module reading its
    slice of it where the leaf was (a subclass with a property, as
    ``torch.nn.utils.parametrize`` does)."""
    from repro_torch import interop

    want = [n for n in names if n.startswith(interop.STACKED)]
    if not want:
        return
    groups: dict = {}
    for name, p in model.named_parameters():
        path, idx = interop.lm_split_name(name)
        groups.setdefault(path, {})[idx] = (name, p)
    for sname in want:
        path, _ = interop.lm_split_name(sname)
        members = groups[path]
        stacked = interop.lm_stack(
            {n: p.detach() for n, p in members.values()}, [sname])[sname]
        holder = model
        for part in ("stacked",) + path[:-1]:
            if part not in holder._modules:
                holder.add_module(part, torch.nn.Module())
            holder = holder._modules[part]
        holder.register_parameter(path[-1], torch.nn.Parameter(
            stacked, requires_grad=any(p.requires_grad
                                       for _, p in members.values())))
        for idx, (name, _) in members.items():
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner)
            del mod._parameters[leaf]
            cls = type(mod)
            mod.__class__ = type(cls.__name__, (cls,),
                                 {leaf: _layer_slice(leaf)})
            slices = dict(mod.__dict__.get("_stacked_slices", {}))
            slices[leaf] = (holder, path[-1], idx)
            mod.__dict__["_stacked_slices"] = slices


def distribute_parameters(model, specs: dict, mesh):
    """Replace each of ``model``'s parameters, in place, by a DTensor
    parameter in its spec's layout; a stacked name of ``specs`` is
    stacked first (:func:`stack_parameters`)."""
    from torch.distributed.tensor import distribute_tensor

    stack_parameters(model, specs)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        setattr(mod, leaf, torch.nn.Parameter(
            distribute_tensor(p.detach(), mesh,
                              placements(specs[name], mesh)),
            requires_grad=p.requires_grad))
    return model


def _pointwise(ndim: int, n_in: int, buffer_like: bool, buffer_at):
    """The acceptable (outputs, inputs) placements of a pointwise op on
    one mesh dim: every tensor sharded on the same dim, or all
    replicated.  The tensor at ``buffer_at`` (``log_sigmoid``'s buffer,
    an output of the forward, an input of the backward) is the input's
    shape on the CPU and on ``meta`` but empty on CUDA, so it follows the
    others only when ``buffer_like``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for pl in [Shard(d) for d in range(ndim)] + [Replicate()]:
        row = [pl] * n_in
        if not buffer_like:
            row[buffer_at] = Replicate()
        out.append(row)
    return out


def _register_strategies() -> None:
    """DTensor strategies for ``log_sigmoid_forward`` and
    ``log_sigmoid_backward`` (``F.logsigmoid`` and its gradient, the
    xLSTM gates), which torch's DTensor lacks, and for ``flip`` (the
    backward of ``cumsum``: the SSD and mLSTM decays), which torch 2.11's
    lacks: pointwise (``flip`` on any dim it does not reverse), registered
    through ``register_sharding``.  The values are the ops' own on each
    rank's shard."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    aten = torch.ops.aten

    @register_sharding(aten.flip.default)
    def _flip(x, dims):
        flipped = {d % x.ndim for d in dims}
        return [([Shard(d)], [Shard(d), None]) for d in range(x.ndim)
                if d not in flipped] + [([Replicate()], [Replicate(), None])]

    @register_sharding(aten.log_sigmoid_forward.default)
    def _forward(x):
        like = x.device_mesh.device_type != "cuda"
        return [(row[:2], row[2:]) for row in
                _pointwise(x.ndim, 3, like, buffer_at=1)]

    @register_sharding(aten.log_sigmoid_backward.default)
    def _backward(grad, x, buffer):
        like = buffer.ndim == x.ndim
        return [(row[:1], row[1:]) for row in
                _pointwise(x.ndim, 4, like, buffer_at=3)]


_register_strategies()


def even_placements(pl, shape, mesh) -> list:
    """``pl`` with ``Replicate()`` on each mesh dim that would split its
    tensor dim unevenly, after the mesh dims before it (16 rows over
    2 x 16 ranks keep the 2): DTensor flattens an unevenly split dim with
    the wrong local shapes, where GSPMD pads."""
    from torch.distributed.tensor import Replicate

    left, out = list(shape), []
    for p, n in zip(pl, mesh.shape):
        if p.is_shard() and left[p.dim] % n:
            p = Replicate()
        elif p.is_shard():
            left[p.dim] //= n
        out.append(p)
    return out


def with_sharding(ctx: Optional[ShardingCtx], x, *axes: Optional[str]):
    """Redistribute a DTensor ``x`` to the logical ``axes`` on ``ctx``'s
    mesh, a mesh dim that would split a dim unevenly left replicated
    (:func:`even_placements`); the identity without a context or on a
    plain tensor."""
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(ctx.mesh, even_placements(
        ctx.placements(*axes), x.shape, ctx.mesh))
