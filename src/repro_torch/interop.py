"""Carry state between the JAX reference and the port.

The reference's arrays arrive as numpy (the caller runs
``jax.tree.map(np.asarray, tree)``) and leave the port as numpy with the
reference's dtypes.  This module owns the dtype map, both ways:

=====================  =========================  ==========================
reference              port                       which leaves
=====================  =========================  ==========================
uint32 hash words      int32, same bit pattern    fields ``hkey``, ``hkeys``
uint32 counters        int64 in [0, 2**32 - 1]    every other uint32 leaf
int32 / float32 /      unchanged                  everything else
bool / uint8
=====================  =========================  ==========================

NamedTuples map by class name and field name, so a reference tree becomes
the port's tree of the same shape; a plain tuple (NoCache's empty policy
``()``) maps item by item.  The reference ``SimCarry.rng`` has no
counterpart: the port carries a draw source (``SimCarry.draws``) instead.

A language model's parameters and decode state cross with
:func:`lm_params_from_reference`, :func:`lm_state_from_reference` and
:func:`lm_state_to_reference`: the reference stacks layers on leading
axes, the port keeps one module (one state entry) per layer.  bfloat16
leaves arrive as ``ml_dtypes`` arrays and leave the port as float32 numpy
(exact; numpy has no bfloat16 of its own).  Training crosses the other
way with :func:`lm_params_to_reference` (parameters or their grads) and
the AdamW state with :func:`adamw_state_from_reference` and
:func:`adamw_state_to_reference`.
"""
from __future__ import annotations

import numpy as np
import torch

HKEY_FIELDS = ("hkey", "hkeys")
_U32_MAX = 2**32 - 1


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _port_classes() -> dict[str, type]:
    from repro_torch.baselines import netcache
    from repro_torch.core import (
        controller, distributed, orbit, pipeline, sketch, types,
    )
    from repro_torch.kernels.subround import ops
    from repro_torch.kvstore import client, server, simulator, workload
    from repro_torch.models import embedding, moe, ssm, xlstm
    from repro_torch.serving import orbit_service
    mods = (types, pipeline, orbit, sketch, controller, ops, client, server,
            simulator, workload, netcache, distributed, orbit_service,
            embedding, moe, ssm, xlstm)
    return {name: obj for m in mods for name, obj in vars(m).items()
            if isinstance(obj, type) and issubclass(obj, tuple)
            and hasattr(obj, "_fields")}


def to_numpy(x, name: str | None = None):
    """Port tensor (or tree of them) -> numpy with the reference dtypes.

    Leaves that are not tensors (a draw source) pass through unchanged.
    The arrays never share memory with the tensors, which a later chunk
    overwrites.
    """
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        a = x.detach().to("cpu", copy=True).numpy()
        if name in HKEY_FIELDS:
            return a.view(np.uint32)
        if a.dtype == np.int64:
            if a.size and (a.min() < 0 or a.max() > _U32_MAX):
                raise ValueError(f"{name}: int64 counter outside uint32")
            return a.astype(np.uint32)
        return a
    if _is_namedtuple(x):
        return type(x)(*(to_numpy(getattr(x, f), f) for f in x._fields))
    if isinstance(x, tuple):
        return tuple(to_numpy(v, name) for v in x)
    return x


def from_numpy(x, device, name: str | None = None):
    """Reference numpy array (or tree) -> the port's tensors on ``device``."""
    if _is_namedtuple(x):
        cls = _port_classes()[type(x).__name__]
        return cls(**{f: from_numpy(getattr(x, f), device, f)
                      for f in cls._fields})
    if isinstance(x, tuple):
        return tuple(from_numpy(v, device, name) for v in x)
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32) if name in HKEY_FIELDS else a.astype(np.int64)
    if a.dtype.name == "bfloat16":
        bits = np.array(a, copy=True, order="C").view(np.uint16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def switch_state_from_numpy(sw, device):
    """Reference ``SwitchState`` (numpy leaves) -> the port's."""
    return from_numpy(sw, device)


def ring_state_from_numpy(st, device):
    """Reference ``RingState`` (numpy leaves, stacked ``[D, ...]`` or one
    position's) -> the port's."""
    return from_numpy(st, device)


def service_state_from_numpy(st, device):
    """Reference ``ServiceState`` (numpy leaves) -> the port's."""
    return from_numpy(st, device)


def workload_from_numpy(arrays, device):
    """Reference ``WorkloadArrays`` (numpy leaves) -> the port's."""
    return from_numpy(arrays, device)


def carry_from_numpy(carry, draws, device):
    """Reference ``SimCarry`` (numpy leaves) -> the port's, with ``draws``
    in place of the reference's PRNG key."""
    from repro_torch.kvstore.simulator import SimCarry
    return SimCarry(**{f: (draws if f == "draws"
                           else from_numpy(getattr(carry, f), device, f))
                       for f in SimCarry._fields})


def fleet_carry_from_numpy(carry, draws, device):
    """A reference fleet's stacked ``SimCarry`` ([P, ...] numpy leaves) ->
    the port fleet's, with ``draws`` (one source per point, such as a
    ``ReplayDraws`` row each) in place of the reference's PRNG keys."""
    from repro_torch.kvstore.fleet import FleetDraws
    return carry_from_numpy(carry, FleetDraws(draws), device)


def fabric_carry_from_numpy(carry, draws, device):
    """Reference ``FabricCarry`` (numpy leaves) -> the port's, with
    ``draws`` (a ``FabricDraws``: the racks' sources and the target source)
    in place of the reference's rack keys and ``fabric_rng``.  A stacked
    carry (a batched fabric's, ``[P, ...]`` leaves) crosses the same way,
    with a ``BatchedFabricDraws``."""
    from repro_torch.kvstore.fabric_sim import FabricCarry
    return FabricCarry(
        racks=carry_from_numpy(carry.racks, (), device),
        spine=from_numpy(carry.spine, device),
        spine_clients=from_numpy(carry.spine_clients, device),
        draws=draws,
        local_frac=from_numpy(carry.local_frac, device),
        spine_drops=from_numpy(carry.spine_drops, device))


# leading layer axes the reference stacks, per top-level key
LM_PARAM_STACKED = {"blocks": 1, "dense_blocks": 1, "slstm": 1,
                    "mamba_lead": 1, "mlstm": 2, "mamba": 2}
LM_STATE_STACKED = {"cache": 1, "dense_cache": 1, "attn_cache": 1,
                    "slstm": 1, "lead": 1, "mlstm": 2, "mamba": 2}


# A leaf whose stacked layer axes the reference shards over a mesh axis
# (a qkv bias under fsdp, parallel.param_specs.tree_specs) is held whole,
# stacked as the reference stacks it, under this prefix and its key path:
# ``stacked.blocks.attn.wq.b`` in place of ``blocks.<i>.attn.wq.b``.
STACKED = "stacked."


def lm_split_name(name: str) -> tuple[tuple, tuple]:
    """A port parameter name -> (the reference's key path, its layer
    indices): ``blocks.3.attn.wq.b`` -> ``(('blocks', 'attn', 'wq',
    'b'), (3,))``; a stacked leaf's indices are ``()``."""
    if name.startswith(STACKED):
        return tuple(name[len(STACKED):].split(".")), ()
    parts = name.split(".")
    depth = LM_PARAM_STACKED.get(parts[0], 0)
    return ((parts[0], *parts[1 + depth:]),
            tuple(int(i) for i in parts[1: 1 + depth]))


def lm_reference_key(path: tuple) -> str:
    """A key path as the reference's ``tree_flatten_with_path`` prints
    it: ``['blocks']/['attn']/['wk']/['b']``."""
    return "/".join(f"[{q!r}]" for q in path)


def lm_stacked_name(path: tuple) -> str:
    return STACKED + ".".join(path)


def lm_layer_name(path: tuple, idx: tuple) -> str:
    return ".".join((path[0], *map(str, idx), *path[1:]))


def _stack_nested_with(stack, items):
    """``{(i, j, ...): leaf}`` -> one leaf stacked (by ``stack``) on the
    index axes."""
    firsts = sorted({idx[0] for idx in items})
    if len(next(iter(items))) == 1:
        return stack([items[(i,)] for i in firsts])
    return stack([_stack_nested_with(stack, {
        idx[1:]: a for idx, a in items.items() if idx[0] == i})
        for i in firsts])


def lm_stack(tree: dict, names) -> dict:
    """``tree`` (port parameter names -> tensors, one per layer) in the
    layout of ``names``: each stacked name's per-layer leaves stacked on
    its leading axes, at the place of its first layer; the other leaves
    as they are."""
    want = set(names)
    if set(tree) == want:
        return dict(tree)
    groups: dict = {}
    for k, v in tree.items():
        path, idx = lm_split_name(k)
        groups.setdefault(path, {})[idx] = v
    out = {}
    for k, v in tree.items():
        path, _ = lm_split_name(k)
        s = lm_stacked_name(path)
        if k in want or s not in want:
            out[k] = v
        elif s not in out:
            out[s] = _stack_nested_with(torch.stack, groups[path])
    if set(out) != want:
        raise KeyError(f"cannot lay out {sorted(set(out) ^ want)[:4]}")
    return out


def lm_unstack(tree: dict) -> dict:
    """The inverse of :func:`lm_stack`: each stacked leaf split into its
    per-layer leaves (a DTensor's full tensor first)."""
    from torch.distributed.tensor import DTensor

    out = {}
    for k, v in tree.items():
        if not k.startswith(STACKED):
            out[k] = v
            continue
        path, _ = lm_split_name(k)
        if isinstance(v, DTensor):
            v = v.full_tensor()
        depth = LM_PARAM_STACKED.get(path[0], 0)
        for idx in np.ndindex(*v.shape[:depth]):
            out[lm_layer_name(path, idx)] = v[idx]
    return out


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def lm_tree_from_reference(tree, device):
    """A reference tree shaped like the parameters (numpy leaves) -> a
    dict of the port's parameter names -> tensors on ``device``, stacked
    leaves (``[L, ...]``; ``[units, k-1, ...]`` for mLSTM, ``[units, k,
    ...]`` for Mamba) split per layer."""
    out = {}
    for path, leaf in _paths(tree):
        a = np.asarray(leaf)
        depth = LM_PARAM_STACKED.get(path[0], 0)
        for idx in np.ndindex(*a.shape[:depth]):
            key = ".".join((path[0], *map(str, idx), *path[1:]))
            out[key] = from_numpy(a[idx], device)
    return out


def lm_params_from_reference(model, tree):
    """Load the reference's parameter tree (``init_params``'s dict, numpy
    leaves) into the port's ``models.Model`` of the same config, in place;
    returns ``model``.  Every one of the model's parameters must be
    matched; stacked leaves load whole, and DTensor parameters take
    their slice of each leaf."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    params = dict(model.named_parameters())
    state = lm_stack(lm_tree_from_reference(tree, "cpu"), params)
    for k, p in params.items():
        if isinstance(p, DTensor):
            state[k] = distribute_tensor(state[k], p.device_mesh,
                                         p.placements, src_data_rank=None)
    model.load_state_dict(state, strict=True)
    return model


def lm_params_to_reference(params):
    """The port's parameters (a ``models.Model``, or a dict of its
    parameter names -> tensors, such as their grads) -> the reference's
    parameter tree: nested dicts of numpy leaves, per-layer leaves stacked
    on the reference's leading axes."""
    if hasattr(params, "named_parameters"):
        params = dict(params.named_parameters())
    from torch.distributed.tensor import DTensor

    groups: dict = {}
    for name, t in params.items():
        path, idx = lm_split_name(name)
        if isinstance(t, DTensor):
            t = t.full_tensor()
        groups.setdefault(path, {})[idx] = to_numpy(t)
    tree: dict = {}
    for path, items in groups.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = (items[()] if () in items
                          else _stack_nested(items))
    return tree


def lm_reference_shapes(params) -> dict:
    """The port's parameter names (a dict of name -> tensor or shape) ->
    ``(path, shape)`` of the reference leaf each is a slice of: its key
    path as the reference's ``tree_flatten_with_path`` prints it
    (``['blocks']/['attn']/['wk']/['b']``) and its stacked shape, the
    layer counts (taken from the names) leading; a stacked leaf's shape
    is its own."""
    counts: dict = {}
    split = {}
    for name, leaf in params.items():
        path, idx = lm_split_name(name)
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)
        split[name] = (path, idx, shape)
        n = counts.setdefault(path, [0] * len(idx))
        counts[path] = [max(a, i + 1) for a, i in zip(n, idx)]
    return {name: (lm_reference_key(path), (*counts[path], *shape))
            for name, (path, _, shape) in split.items()}


def lm_specs_to_reference(specs: dict) -> dict:
    """Per-parameter specs of the port (name -> tuple of entries) -> the
    reference's tree of specs: nested dicts, each leaf's stacked layer
    axes put back as leading ``None`` entries (every layer of a leaf must
    have the same spec).  Leaves are plain tuples."""
    tree: dict = {}
    for name, spec in specs.items():
        path, idx = lm_split_name(name)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        full = (None,) * len(idx) + tuple(spec)
        if node.setdefault(path[-1], full) != full:
            raise ValueError(f"{name}: {full} differs from another layer's "
                             f"{node[path[-1]]}")
    return tree


def _stack_nested(items):
    """``{(i, j, ...): array}`` -> one array stacked on the index axes."""
    return _stack_nested_with(np.stack, items)


def adamw_state_from_reference(model, st):
    """The reference's ``AdamWState`` (numpy leaves: ``step``, ``mu`` and
    ``nu`` shaped like the parameter tree) -> the port's, keyed by
    ``model``'s parameter names, on ``model``'s device."""
    from repro_torch.training.optimizer import AdamWState
    dev = model.device
    names = [k for k, _ in model.named_parameters()]
    mu = lm_stack(lm_tree_from_reference(st.mu, dev), names)
    nu = lm_stack(lm_tree_from_reference(st.nu, dev), names)
    names = set(names)
    if set(mu) != names or set(nu) != names:
        raise KeyError("AdamW state does not match the model's parameters: "
                       f"{sorted(set(mu) ^ names)[:4]}")
    return AdamWState(step=from_numpy(st.step, dev), mu=mu, nu=nu)


def adamw_state_to_reference(st):
    """The port's ``AdamWState`` -> the reference's layout (numpy leaves,
    ``mu`` / ``nu`` restacked like :func:`lm_params_to_reference`), as the
    port's ``AdamWState`` class, which has the reference's field names."""
    return type(st)(step=to_numpy(st.step), mu=lm_params_to_reference(st.mu),
                    nu=lm_params_to_reference(st.nu))


def _index(node, i):
    if _is_namedtuple(node):
        return type(node)(*(_index(v, i) for v in node))
    if isinstance(node, tuple):
        return tuple(_index(v, i) for v in node)
    return node[i]


def _first_leaf(node):
    return _first_leaf(node[0]) if isinstance(node, tuple) else node


def _unstack(node, depth, device):
    if depth == 0:
        return from_numpy(node, device)
    return [_unstack(_index(node, i), depth - 1, device)
            for i in range(len(_first_leaf(node)))]


def _stack(parts):
    first = parts[0]
    if isinstance(first, tuple):
        items = [_stack([p[i] for p in parts]) for i in range(len(first))]
        return type(first)(*items) if _is_namedtuple(first) else tuple(items)
    return np.stack(parts)


def _restack(items, depth):
    if depth == 0:
        return to_numpy(items)
    return _stack([_restack(x, depth - 1) for x in items])


def lm_state_from_reference(state, device):
    """The reference's decode state (``init_decode_state``'s dict, numpy
    leaves, its ``-1e30`` / ``1e-6`` initial values included) -> the
    port's, one entry per layer on ``device``."""
    return {k: _unstack(v, LM_STATE_STACKED.get(k, 0), device)
            for k, v in state.items()}


def lm_state_to_reference(state):
    """The port's decode state -> the reference's layout: numpy leaves,
    layers stacked on the leading axes (the port's NamedTuples keep the
    reference's class and field names)."""
    return {k: _restack(v, LM_STATE_STACKED.get(k, 0))
            for k, v in state.items()}
