"""Checkpointing with atomic commit (port of
``repro.training.checkpoint``), over a nested tree of tensors: dicts,
lists, tuples and NamedTuples (an ``AdamWState``).

Layout (one directory per step), the reference's:

    ckpt_dir/step_000123/
        meta.json            tree structure, shapes, dtypes
        shard_00000.npz      the leaves (flat key -> array)
        COMMITTED            written last -- a checkpoint without it is torn

* **Atomic**: writers dump to ``step_N.tmp`` then rename; the COMMITTED
  marker is created and fsynced last.  ``latest()`` ignores uncommitted
  directories, so a crash mid-save never corrupts the restore path.
* Flat keys are the reference's key paths (``['params']/['w']``, ``[0]``
  for a list item, ``.mu`` for a NamedTuple field); bfloat16 leaves are
  stored as their ``uint16`` bit patterns (npz has no bfloat16), and
  ``meta.json`` keeps the stored dtype.
* Leaves are stored whole (a DTensor's full tensor); ``restore`` places
  each on a mesh with ``distribute_tensor`` when ``shardings`` names one,
  so restoring onto a different mesh (the elastic restore) is passing the
  new shardings.
* A stacked parameter leaf (``interop.STACKED``, a layout of the sharded
  step) is stored as its per-layer leaves, the plain layout; ``restore``
  stacks them again wherever ``like`` or ``shardings`` names the stacked
  leaf, so either layout restores the other's checkpoint.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """``(key, child)`` pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", v) for k, v in node.items()]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def _stacked(node) -> bool:
    from repro_torch import interop

    return isinstance(node, dict) and any(
        isinstance(k, str) and k.startswith(interop.STACKED) for k in node)


def _plain(tree):
    """``tree`` with every stacked parameter leaf split per layer."""
    from repro_torch import interop

    if _stacked(tree):
        tree = interop.lm_unstack(tree)
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_plain(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(v) for v in tree)
    return tree


def _flat(tree, prefix=()):
    kids = _children(tree)
    if kids is None:
        yield "/".join(prefix), tree
        return
    for k, v in kids:
        yield from _flat(v, prefix + (k,))


def _treedef(tree) -> str:
    kids = _children(tree)
    if kids is None:
        return "*"
    inner = ", ".join(f"{k}: {_treedef(v)}" for k, v in kids)
    return f"{type(tree).__name__}({inner})"


def _to_numpy(leaf) -> np.ndarray:
    """The leaf on the host (a view of a CPU tensor: ``save`` writes it
    before it returns); a DTensor's full tensor."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    t = torch.as_tensor(leaf).detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.uint16)
    return t.numpy()


def _fsync_write(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())


def save(ckpt_dir: str, step: int, tree: Any, extra: dict | None = None) -> str:
    """Atomically write a checkpoint; returns the committed path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    tree = _plain(tree)
    flat = {k: _to_numpy(v) for k, v in _flat(tree)}
    np.savez(os.path.join(tmp, "shard_00000.npz"), **flat)
    meta = {
        "step": step,
        "treedef": _treedef(tree),
        "keys": sorted(flat),
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "extra": extra or {},
    }
    _fsync_write(os.path.join(tmp, "meta.json"), json.dumps(meta))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_write(os.path.join(final, "COMMITTED"), "ok")   # commit last
    return final


def latest(ckpt_dir: str) -> int | None:
    """Latest *committed* step, ignoring torn checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "COMMITTED")):
                best = max(best or -1, int(d.split("_")[1]))
    return best


def restore(ckpt_dir: str, step: int, like: Any, device=None,
            shardings: Any = None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors giving
    each leaf's shape and dtype).  Leaves go to ``device``, or else to the
    device of their ``like`` leaf (a DTensor's local device).

    ``shardings``: a tree shaped like ``like`` whose leaves are ``(mesh,
    placements)`` (or None to keep a leaf whole): each such leaf becomes a
    DTensor on ``mesh``, every rank taking its own slice of the stored
    array.  Elastic restore onto a different mesh passes the new
    shardings."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "COMMITTED")):
        raise FileNotFoundError(f"checkpoint {path} not committed")
    with np.load(os.path.join(path, "shard_00000.npz")) as data:
        return _rebuild(like, (), data, device, shardings)


def _rebuild(node, prefix, data, device, shardings=None):
    if _stacked(node) or _stacked(shardings):
        return _rebuild_stacked(node, prefix, data, device, shardings)
    kids = _children(node)
    if kids is None:
        key = "/".join(prefix)
        arr = data[key]
        like = torch.as_tensor(node)
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                             f"{tuple(like.shape)}")
        t = torch.from_numpy(arr)      # np.load gives a fresh array
        if arr.dtype == np.uint16 and like.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        t = t.to(device=device if device is not None else like.device,
                 dtype=like.dtype)
        if shardings is None:
            return t
        mesh, placements = shardings
        return distribute_tensor(t, mesh, placements, src_data_rank=None)
    sub = dict(_children(shardings)) if shardings is not None else {}
    vals = [_rebuild(v, prefix + (k,), data, device, sub.get(k))
            for k, v in kids]
    if isinstance(node, dict):
        return dict(zip(node, vals))
    if _is_namedtuple(node):
        return type(node)(*vals)
    return type(node)(vals)


def _rebuild_stacked(node, prefix, data, device, shardings):
    """A dict of parameter leaves in which ``node`` or ``shardings``
    names a stacked leaf: the stored per-layer leaves restored, stacked
    in the layout of ``shardings`` (else ``node``), then placed."""
    from repro_torch import interop

    plain = interop.lm_unstack(node)
    vals = {k: _rebuild(v, prefix + (f"[{k!r}]",), data, device)
            for k, v in plain.items()}
    layout = shardings if _stacked(shardings) else node
    out = interop.lm_stack(vals, layout)
    for k, v in out.items():
        sh = (shardings or {}).get(k)
        if sh is not None:
            out[k] = distribute_tensor(v, *sh, src_data_rank=None)
    return out
