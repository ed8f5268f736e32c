"""Kernel dispatch for the port (counterpart of ``repro.kernels``).

Each kernel directory holds ``ref.py`` (the plain PyTorch version, which
is also the CPU path), the Hopper kernel (``kernel.cu`` and its loader
``kernel.py``) and ``ops.py`` (the wrapper that launches it).

Backends
--------
* ``cuda``  the hand-written kernels; CUDA tensors only;
* ``ref``   the plain PyTorch versions, on any device.

Resolution order: :func:`set_kernel_backend` > ``REPRO_TORCH_KERNEL_BACKEND``
> the device of the data (``cuda`` for CUDA tensors, ``ref`` for CPU
tensors).  Asking for ``cuda`` with CPU tensors is an error.

``LAUNCHES`` counts kernel launches by kernel name: a wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.  ``CALLS`` counts the calls of the
five dispatchers below, on either backend (a batched call once, as it
launches once): on ``cuda`` each call launches once, so the two agree,
and on ``ref`` ``LAUNCHES`` stays 0 while ``CALLS`` still counts the
kernel calls a path makes, the number the card's launches must equal.

The fleet
---------
A fleet of racks (``kvstore.fleet``) runs the window under
``torch.func.vmap`` over its points.  There ``subround``,
``cms_update_query``, ``hot_gather`` and ``reply_values`` are
``torch.library`` custom ops
with a batching rule: the rule moves each batched input's point axis to
the front, passes a shared input (``in_dims`` None) once with a point
stride of 0, and calls the kernel's *points op* (``repro_torch::
<name>_points``), which makes ONE batched launch for all points (on the
``ref`` backend it calls the plain version once per point).  Called with
no batched tensor, a dispatcher takes the serial path.

A fabric sweep (``fleet.BatchedFabricSimulator``) nests a second vmap
level: the racks inside the points.  A points op has its own batching
rule, which folds the outer level into the point axis (``Q`` outer by
``P`` inner points become ``Q * P``) and calls the points op again, so
every level ends in the same ONE launch.  An input that one level shares
and the other does not is expanded to the full ``Q * P`` (a kernel takes
one stride a point); one shared by both stays shared.
"""
from __future__ import annotations

import os

import torch
from torch._C._functorch import is_batchedtensor

# Bind the kernel subpackages BEFORE the same-named dispatchers below, so
# the dispatcher functions shadow the subpackage attributes for good.
from . import cms as _cms_pkg  # noqa: F401, E402
from . import hot_gather as _hot_gather_pkg  # noqa: F401, E402
from . import orbit_match as _orbit_match_pkg  # noqa: F401, E402
from . import reply_values as _reply_values_pkg  # noqa: F401, E402
from . import subround as _subround_pkg  # noqa: F401, E402

KERNEL_BACKENDS = ("cuda", "ref")
_ENV_VAR = "REPRO_TORCH_KERNEL_BACKEND"
_forced: str | None = None

LAUNCHES: dict[str, int] = {"subround": 0, "cms": 0, "hot_gather": 0,
                            "orbit_match": 0, "reply_values": 0}
CALLS: dict[str, int] = dict.fromkeys(LAUNCHES, 0)


def reset_launch_counts() -> None:
    """Zero ``LAUNCHES`` and ``CALLS``."""
    for counts in (LAUNCHES, CALLS):
        for k in counts:
            counts[k] = 0


def set_kernel_backend(name: str | None) -> None:
    """Force a kernel backend for this process (``None`` restores auto)."""
    global _forced
    if name is not None and name not in KERNEL_BACKENDS:
        raise ValueError(f"unknown kernel backend {name!r}; "
                         f"expected one of {KERNEL_BACKENDS}")
    _forced = name


def kernel_backend(device: torch.device) -> str:
    """Resolve the backend for data on ``device``: forced > env > device."""
    be = _forced
    if be is None:
        be = os.environ.get(_ENV_VAR, "").strip().lower() or None
        if be is not None and be not in KERNEL_BACKENDS:
            raise ValueError(f"{_ENV_VAR}={be!r}; "
                             f"expected one of {KERNEL_BACKENDS}")
    if be is None:
        return "cuda" if device.type == "cuda" else "ref"
    if be == "cuda" and device.type != "cuda":
        raise ValueError(f"kernel backend 'cuda' needs CUDA tensors; the "
                         f"data lies on {device}")
    return be


def orbit_match(hkey, table_hkeys, occupied, valid, pop_mask=None,
                block_b: int = 256):
    """Fused match-action lookup: ``(cidx [B], hit [B], valid_hit [B],
    pop [C])``, int32.

    128-bit exact match of ``hkey`` (int32[B, 4] bit patterns) against the
    occupied table entries (the first match wins), the validity filter, and
    per-entry popularity over the lanes with ``pop_mask > 0``.
    ``block_b`` is the reference's lane tile, kept for its signature: no
    result depends on it.
    """
    from .orbit_match import ops
    from .orbit_match import ref as om_ref

    CALLS["orbit_match"] += 1
    if kernel_backend(hkey.device) == "ref":
        return om_ref.orbit_match_ref(hkey, table_hkeys, occupied, valid,
                                      pop_mask)
    return ops.orbit_match(hkey, table_hkeys, occupied, valid, pop_mask)


def subround(
    hkey, want, wreq, inst, frag, nfrags, kidx, vlen, client, seq, port, ts,
    table_hkeys, occupied, st_valid, st_version,
    rt_client, rt_seq, rt_port, rt_ts, rt_acked, rt_kidx, qlen, front, rear,
    ob_live, ob_kidx, ob_version, ob_vlen, ob_frags,
    budget,
    queue_size: int, max_frags: int, max_serves: int,
):
    """The full per-subround switch pass as one fused op (paper Fig. 4).

    128-bit match, validity, popularity, request-table admission and
    metadata apply, the state-table pass, the orbit-line metadata install
    and the serving round.  Gate masks already include lane validity.
    Returns an ``ops.SubroundOuts``.
    """
    from .subround.ops import SubroundOuts
    from .subround.ops import subround as _sr
    from .subround.ref import subround_ref

    args = (hkey, want, wreq, inst, frag, nfrags, kidx, vlen, client, seq,
            port, ts, table_hkeys, occupied, st_valid, st_version,
            rt_client, rt_seq, rt_port, rt_ts, rt_acked, rt_kidx, qlen,
            front, rear, ob_live, ob_kidx, ob_version, ob_vlen, ob_frags,
            budget)
    CALLS["subround"] += 1
    if _batched(*args):
        budget = torch.as_tensor(budget, device=hkey.device)
        return SubroundOuts(*_subround_op(list(args[:30]) + [budget],
                                          queue_size, max_frags, max_serves))
    if kernel_backend(hkey.device) == "ref":
        return SubroundOuts(*subround_ref(
            *args, queue_size=queue_size, max_frags=max_frags,
            max_serves=max_serves))
    return _sr(*args, queue_size, max_frags, max_serves)


def cms_update_query(hkey, mask, counts, block_b: int = 256):
    """Fused count-min update + query (paper §3.8 server sketch).

    ``hkey`` int32[B, 4]; ``counts`` int32[..., 5, W] and ``mask``
    [..., B] carry an optional leading axis of sketches over the one
    batch.  Returns ``(counts', est int32[..., B])``: each masked lane's
    estimate against the sketch as of the start of its tile of
    ``min(block_b, max(8, B))`` lanes.
    """
    from .cms import ops
    from .cms import ref as cms_ref

    CALLS["cms"] += 1
    if _batched(hkey, mask, counts):
        return tuple(_cms_op(hkey, mask, counts, block_b))
    if kernel_backend(hkey.device) == "ref":
        idx = ops.rows_for(hkey, counts.shape[-1])
        return cms_ref.cms_update_query_fast(
            idx, mask.to(torch.int32), counts,
            block_b=ops.tile_for(hkey.shape[0], block_b))
    return ops.cms_update_query(hkey, mask, counts, block_b)


def hot_gather(ids, hot_ids, rows):
    """Gather-by-id over a hot set: ``(out [B, D], hit int32[B])`` with
    ``out[b]`` the sum of the rows of every hot id equal to ``ids[b]``."""
    from .hot_gather import ops
    from .hot_gather import ref as hg_ref

    CALLS["hot_gather"] += 1
    if _batched(ids, hot_ids, rows):
        return tuple(_hot_gather_op(ids, hot_ids, rows))
    if kernel_backend(ids.device) == "ref":
        return hg_ref.hot_gather_ref(ids, hot_ids, rows)
    return ops.hot_gather(ids, hot_ids, rows)


def reply_values(kidx, version, vlen, carries_val, max_frags: int,
                 pad: int):
    """The value bytes of a server step's reply lanes: uint8[n * cap *
    max_frags, pad] for int32 ``kidx``, ``version``, ``vlen`` and bool
    ``carries_val`` [n, cap] (``ops`` and ``ref`` say which bytes)."""
    from .reply_values import ops
    from .reply_values import ref as rv_ref

    CALLS["reply_values"] += 1
    if _batched(kidx, version, vlen, carries_val):
        return _reply_values_op(kidx, version, vlen, carries_val, max_frags,
                                pad)
    if kernel_backend(kidx.device) == "ref":
        return rv_ref.reply_values_ref(kidx, version, vlen, carries_val,
                                       max_frags, pad)
    return ops.reply_values(kidx, version, vlen, carries_val, max_frags, pad)


# ---------------------------------------------------------------------------
# the fleet: custom ops whose batching rule launches once for all points
# ---------------------------------------------------------------------------
def _batched(*xs) -> bool:
    """Whether any argument is a tensor batched by ``torch.func.vmap``."""
    return any(isinstance(x, torch.Tensor) and is_batchedtensor(x)
               for x in xs)


def _front(x, d):
    """A rule's input with its point axis first (``d`` None: shared)."""
    return x if d is None else x.movedim(d, 0)


def _unaliased(outs, ins):
    """A custom op may not return its inputs: copy any output that is
    one."""
    ptrs = {x.data_ptr() for x in ins if isinstance(x, torch.Tensor)}
    return [o.clone() if o.data_ptr() in ptrs else o for o in outs]


def _per_point(fn, p, args, batched):
    """The plain version once per point, stacked (``batched[k]``: input k
    has the point axis first)."""
    per = [fn(*(a[i] if bt else a for a, bt in zip(args, batched)))
           for i in range(p)]
    return [torch.stack(x) for x in zip(*per)]


def _fold(q, p, args, dims, inner):
    """A points op's inputs under an outer vmap level of ``q`` points
    (``dims``: each input's axis of that level, or None): the ``[q * p,
    ...]`` inputs of one points op, and which are batched.  ``inner[k]``:
    input k has the op's own point axis (``p``) first."""
    out, flags = [], []
    for a, d, bt in zip(args, dims, inner):
        if d is None and not bt:
            out.append(a)
            flags.append(False)
            continue
        a = a.expand((q,) + a.shape) if d is None else a.movedim(d, 0)
        if not bt:
            a = a.unsqueeze(1).expand((q, p) + a.shape[1:])
        out.append(a.reshape((q * p,) + a.shape[2:]))
        flags.append(True)
    return out, flags


def _has_points(args, dims, base):
    """Whether each input carries the point axis: one dimension more than
    its ``base`` rank, not counting the vmap level's own (``dims``)."""
    return [a.dim() - (d is not None) > n
            for a, d, n in zip(args, dims, base)]


def _unfold(outs, q, p):
    return [o.reshape((q, p) + o.shape[1:]) for o in outs], [0] * len(outs)


# -- subround ---------------------------------------------------------------
@torch.library.custom_op("repro_torch::subround", mutates_args=())
def _subround_op(args: list[torch.Tensor], queue_size: int, max_frags: int,
                 max_serves: int) -> list[torch.Tensor]:
    return _unaliased(subround(*args, queue_size=queue_size,
                               max_frags=max_frags, max_serves=max_serves),
                      args)


def _subround_vmap(info, in_dims, args, queue_size, max_frags, max_serves):
    dims = in_dims[0]
    args = [_front(a, d) for a, d in zip(args, dims)]
    outs = _subround_points_op(args, [d is not None for d in dims],
                               info.batch_size, queue_size, max_frags,
                               max_serves)
    return outs, [0] * len(outs)


torch.library.register_vmap("repro_torch::subround", _subround_vmap)


@torch.library.custom_op("repro_torch::subround_points", mutates_args=())
def _subround_points_op(args: list[torch.Tensor], batched: list[bool],
                        p: int, queue_size: int, max_frags: int,
                        max_serves: int) -> list[torch.Tensor]:
    """``p`` switch instances: ``subround_batched``'s one launch."""
    from .subround import ref as sr_ref
    from .subround.ops import subround_batched

    if kernel_backend(args[0].device) == "ref":
        outs = _per_point(
            lambda *a: sr_ref.subround_ref(*a, queue_size=queue_size,
                                           max_frags=max_frags,
                                           max_serves=max_serves),
            p, args, batched)
    else:
        outs = list(subround_batched(args, batched, p, queue_size, max_frags,
                                     max_serves))
    return _unaliased(outs, args)


def _subround_points_vmap(info, in_dims, args, batched, p, queue_size,
                          max_frags, max_serves):
    q = info.batch_size
    args, batched = _fold(q, p, args, in_dims[0], batched)
    return _unfold(_subround_points_op(args, batched, q * p, queue_size,
                                       max_frags, max_serves), q, p)


torch.library.register_vmap("repro_torch::subround_points",
                            _subround_points_vmap)


# -- count-min --------------------------------------------------------------
@torch.library.custom_op("repro_torch::cms_update_query", mutates_args=())
def _cms_op(hkey: torch.Tensor, mask: torch.Tensor, counts: torch.Tensor,
            block_b: int) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(_unaliased(cms_update_query(hkey, mask, counts, block_b),
                            (hkey, mask, counts)))


def _cms_vmap(info, in_dims, hkey, mask, counts, block_b):
    from .cms import ops

    p = info.batch_size
    hkey, mask, counts = (_front(a, d) for a, d in
                          zip((hkey, mask, counts), in_dims[:3]))
    # per-point sketches: the rule's outputs always carry the point axis
    if in_dims[1] is None:
        mask = mask.expand((p,) + mask.shape)
    if in_dims[2] is None:
        counts = counts.expand((p,) + counts.shape)
    idx = ops.rows_for(hkey, counts.shape[-1])     # [P, B, 5] or [B, 5]
    tile = ops.tile_for(hkey.shape[-2], block_b)
    return tuple(_cms_points_op(idx, mask, counts, tile)), (0, 0)


torch.library.register_vmap("repro_torch::cms_update_query", _cms_vmap)


@torch.library.custom_op("repro_torch::cms_points", mutates_args=())
def _cms_points_op(idx: torch.Tensor, mask: torch.Tensor,
                   counts: torch.Tensor, tile: int,
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """P points' sketches ``counts[P, n, 5, W]``, ``mask[P, n, B]``, row
    indices ``idx[P, B, 5]`` or shared ``[B, 5]``: ``update_query_batched``'s
    one launch."""
    from .cms import ops
    from .cms import ref as cms_ref

    if kernel_backend(idx.device) == "ref":
        outs = _per_point(
            lambda i, m, c: cms_ref.cms_update_query_fast(
                i, m.to(torch.int32), c, block_b=tile),
            counts.shape[0], (idx, mask, counts), (idx.dim() == 3, 1, 1))
    else:
        outs = ops.update_query_batched(idx, mask, counts, tile)
    return tuple(_unaliased(outs, (idx, mask, counts)))


def _cms_points_vmap(info, in_dims, idx, mask, counts, tile):
    q, dims = info.batch_size, in_dims[:3]
    p = _front(counts, dims[2]).shape[-4]      # [(Q,) P, n, 5, W]
    args, _ = _fold(q, p, (idx, mask, counts), dims,
                    _has_points((idx, mask, counts), dims, (2, 2, 3)))
    return tuple(_unfold(_cms_points_op(*args, tile), q, p)[0]), (0, 0)


torch.library.register_vmap("repro_torch::cms_points", _cms_points_vmap)


# -- hot_gather -------------------------------------------------------------
@torch.library.custom_op("repro_torch::hot_gather", mutates_args=())
def _hot_gather_op(ids: torch.Tensor, hot_ids: torch.Tensor,
                   rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(_unaliased(hot_gather(ids, hot_ids, rows),
                            (ids, hot_ids, rows)))


def _hot_gather_vmap(info, in_dims, ids, hot_ids, rows):
    args = [_front(a, d) for a, d in zip((ids, hot_ids, rows), in_dims)]
    return tuple(_hot_gather_points_op(*args, info.batch_size)), (0, 0)


torch.library.register_vmap("repro_torch::hot_gather", _hot_gather_vmap)


@torch.library.custom_op("repro_torch::hot_gather_points", mutates_args=())
def _hot_gather_points_op(ids: torch.Tensor, hot_ids: torch.Tensor,
                          rows: torch.Tensor, p: int,
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """P points, each input ``[P, ...]`` or shared (one rank less):
    ``hot_gather_batched``'s one launch."""
    from .hot_gather import ops
    from .hot_gather import ref as hg_ref

    args = (ids, hot_ids, rows)
    if kernel_backend(ids.device) == "ref":
        outs = _per_point(hg_ref.hot_gather_ref, p, args,
                          _has_points(args, (None,) * 3, (1, 1, 2)))
    else:
        outs = ops.hot_gather_batched(*args, p)
    return tuple(_unaliased(outs, args))


def _hot_gather_points_vmap(info, in_dims, ids, hot_ids, rows, p):
    q, args = info.batch_size, (ids, hot_ids, rows)
    args, _ = _fold(q, p, args, in_dims[:3],
                    _has_points(args, in_dims[:3], (1, 1, 2)))
    return tuple(_unfold(_hot_gather_points_op(*args, q * p), q, p)[0]), \
        (0, 0)


torch.library.register_vmap("repro_torch::hot_gather_points",
                            _hot_gather_points_vmap)


# -- reply_values -----------------------------------------------------------
@torch.library.custom_op("repro_torch::reply_values", mutates_args=())
def _reply_values_op(kidx: torch.Tensor, version: torch.Tensor,
                     vlen: torch.Tensor, carries_val: torch.Tensor,
                     max_frags: int, pad: int) -> torch.Tensor:
    return reply_values(kidx, version, vlen, carries_val, max_frags, pad)


def _reply_values_vmap(info, in_dims, kidx, version, vlen, carries_val,
                       max_frags, pad):
    args = [_front(a, d) for a, d in
            zip((kidx, version, vlen, carries_val), in_dims[:4])]
    return _reply_values_points_op(*args, info.batch_size, max_frags,
                                   pad), 0


torch.library.register_vmap("repro_torch::reply_values",
                            _reply_values_vmap)


@torch.library.custom_op("repro_torch::reply_values_points",
                         mutates_args=())
def _reply_values_points_op(kidx: torch.Tensor, version: torch.Tensor,
                            vlen: torch.Tensor, carries_val: torch.Tensor,
                            p: int, max_frags: int, pad: int,
                            ) -> torch.Tensor:
    """P points, each input ``[P, n, cap]`` or shared ``[n, cap]``:
    ``reply_values_batched``'s one launch (on ``ref`` the plain version
    once, the shared inputs broadcast)."""
    from .reply_values import ops
    from .reply_values import ref as rv_ref

    args = (kidx, version, vlen, carries_val)
    if kernel_backend(kidx.device) == "ref":
        return rv_ref.reply_values_ref(*args, max_frags, pad)
    return ops.reply_values_batched(*args, p, max_frags, pad)


def _reply_values_points_vmap(info, in_dims, kidx, version, vlen,
                              carries_val, p, max_frags, pad):
    q, args = info.batch_size, (kidx, version, vlen, carries_val)
    args, _ = _fold(q, p, args, in_dims[:4],
                    _has_points(args, in_dims[:4], (2,) * 4))
    out = _reply_values_points_op(*args, q * p, max_frags, pad)
    return out.reshape((q, p) + out.shape[1:]), 0


torch.library.register_vmap("repro_torch::reply_values_points",
                            _reply_values_points_vmap)
