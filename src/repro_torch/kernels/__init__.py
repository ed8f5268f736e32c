"""Kernel dispatch for the port (counterpart of ``repro.kernels``).

Each kernel directory holds ``ref.py`` (the plain PyTorch version), the
Hopper kernel (``kernel.cu`` and its loader ``kernel.py``) and ``ops.py``
(the wrapper that launches it on CUDA tensors and refuses any other).
This module alone chooses between the plain version and the kernel.

Backends
--------
* ``cuda``  the hand-written kernels; CUDA tensors only;
* ``ref``   the plain PyTorch versions, on any device.

:func:`set_kernel_backend` forces one; else the device of the data picks
(``cuda`` for CUDA tensors, ``ref`` for CPU tensors).  Asking for ``cuda``
with CPU tensors is an error.

``LAUNCHES`` counts kernel launches by kernel name: a wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.  ``CALLS`` counts the calls of the
six dispatchers below, on either backend (a batched call once, as it
launches once): on ``cuda`` each call launches once, so the two agree,
and on ``ref`` ``LAUNCHES`` stays 0 while ``CALLS`` still counts the
kernel calls a path makes, the number the card's launches must equal.

One launch path
---------------
Each kernel but ``orbit_match`` has one wrapper with an optional point
count, ``ops.<name>(..., p=None)``: ``p`` None is one instance, with no
point axis; ``p`` points take each input ``[p, ...]``, or one rank less
where the points share it (a stride of 0), and give every output
``[p, ...]``.  The kernel's *points function* here (``_subround``,
``_cms``, ...) calls that wrapper on ``cuda`` and, on ``ref``, the plain
version once, or once per point (:func:`_per_point`).

The fleet
---------
A fleet of racks (``kvstore.fleet``) runs the window under
``torch.func.vmap`` over its points.  There each kernel is a
``torch.library`` custom op with a batching rule (:func:`_kernel_op`
registers both, and the points op and its rule): the rule moves each
batched input's point axis to the front, passes a shared input
(``in_dims`` None) once, and calls the kernel's *points op*
(``repro_torch::<name>_points``), which runs the points function for all
points: ONE launch.  Called with no batched tensor, a dispatcher runs the
points function for one instance.

A fabric sweep (``fleet.BatchedFabricSimulator``) nests a second vmap
level: the racks inside the points.  A points op has its own batching
rule, which folds the outer level into the point axis (``Q`` outer by
``P`` inner points become ``Q * P``) and calls the points op again, so
every level ends in the same ONE launch.  An input that one level shares
and the other does not is expanded to the full ``Q * P`` (a kernel takes
one stride a point); one shared by both stays shared.
"""
from __future__ import annotations

import torch
from torch._C._functorch import is_batchedtensor

# Bind the kernel subpackages BEFORE the same-named dispatchers below, so
# the dispatcher functions shadow the subpackage attributes for good.
from . import cms as _cms_pkg  # noqa: F401, E402
from . import hot_gather as _hot_gather_pkg  # noqa: F401, E402
from . import orbit_match as _orbit_match_pkg  # noqa: F401, E402
from . import reply_values as _reply_values_pkg  # noqa: F401, E402
from . import server_enqueue as _server_enqueue_pkg  # noqa: F401, E402
from . import subround as _subround_pkg  # noqa: F401, E402
from .subround import ops as _subround_ops  # noqa: E402

KERNEL_BACKENDS = ("cuda", "ref")
_forced: str | None = None

LAUNCHES: dict[str, int] = {"subround": 0, "cms": 0, "hot_gather": 0,
                            "orbit_match": 0, "reply_values": 0,
                            "server_enqueue": 0}
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
    """The backend for data on ``device``: the forced one, else by
    device."""
    if _forced is None:
        return "cuda" if device.type == "cuda" else "ref"
    if _forced == "cuda" and device.type != "cuda":
        raise ValueError(f"kernel backend 'cuda' needs CUDA tensors; the "
                         f"data lies on {device}")
    return _forced


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
    from .orbit_match import ops, ref

    CALLS["orbit_match"] += 1
    if kernel_backend(hkey.device) == "ref":
        return ref.orbit_match_ref(hkey, table_hkeys, occupied, valid,
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
    args = [hkey, want, wreq, inst, frag, nfrags, kidx, vlen, client, seq,
            port, ts, table_hkeys, occupied, st_valid, st_version,
            rt_client, rt_seq, rt_port, rt_ts, rt_acked, rt_kidx, qlen,
            front, rear, ob_live, ob_kidx, ob_version, ob_vlen, ob_frags,
            budget]
    CALLS["subround"] += 1
    if _batched(*args):
        args[30] = torch.as_tensor(budget, device=hkey.device)
    return _subround_ops.SubroundOuts(*_call(
        _subround_op, _subround, args, [queue_size, max_frags, max_serves]))


def cms_update_query(hkey, mask, counts, block_b: int = 256):
    """Fused count-min update + query (paper §3.8 server sketch).

    ``hkey`` int32[B, 4]; ``counts`` int32[..., 5, W] and ``mask``
    [..., B] carry an optional leading axis of sketches over the one
    batch.  Returns ``(counts', est int32[..., B])``: each masked lane's
    estimate against the sketch as of the start of its tile of
    ``min(block_b, max(8, B))`` lanes.  Under vmap both outputs carry the
    point axis.
    """
    from .cms.ops import tile_for

    CALLS["cms"] += 1
    return tuple(_call(_cms_op, _cms, [hkey, mask, counts],
                       [tile_for(hkey.shape[-2], block_b)]))


def hot_gather(ids, hot_ids, rows):
    """Gather-by-id over a hot set: ``(out [B, D], hit int32[B])`` with
    ``out[b]`` the sum of the rows of every hot id equal to ``ids[b]``."""
    CALLS["hot_gather"] += 1
    return tuple(_call(_hot_gather_op, _hot_gather, [ids, hot_ids, rows],
                       []))


def reply_values(kidx, version, vlen, carries_val, max_frags: int,
                 pad: int):
    """The value bytes of a server step's reply lanes: uint8[n * cap *
    max_frags, pad] for int32 ``kidx``, ``version``, ``vlen`` and bool
    ``carries_val`` [n, cap] (``ops`` and ``ref`` say which bytes)."""
    CALLS["reply_values"] += 1
    return _call(_reply_values_op, _reply_values,
                 [kidx, version, vlen, carries_val], [max_frags, pad])[0]


def server_enqueue(server, to_server, fields, rings, qlen, rear):
    """The servers' FIFO enqueue of a step's lanes [B]: ``(rings', qlen',
    rear', new_counts, dropped_now, accepted)``.

    ``server`` int32 and ``to_server`` bool [B]; ``fields``, the eight
    lane fields in ring order (int32 op, kidx, seq, client, port, flag,
    vlen; float32 ts) [B]; ``rings``, the eight rings [n, q]; int32
    ``qlen`` and ``rear`` [n].  Each ``to_server`` lane takes the next
    slot of its server's ring, in lane order, while the ring has room;
    ``ref`` says exactly what."""
    CALLS["server_enqueue"] += 1
    outs = _call(_server_enqueue_op, _server_enqueue,
                 [server, to_server, *fields, *rings, qlen, rear], [])
    return outs[:8], *outs[8:]


# ---------------------------------------------------------------------------
# points functions: p instances (None: one) on the backend the data picks
# ---------------------------------------------------------------------------
def _plain(fn, p, args, base):
    """The plain version ``fn`` of one instance: once (``p`` None), or
    once per point, stacked."""
    if p is None:
        return list(fn(*args))
    return _per_point(fn, p, args,
                      _has_points(args, (None,) * len(args), base))


def _per_point(fn, p, args, batched):
    """The plain version once per point, stacked (``batched[k]``: input k
    has the point axis first)."""
    per = [fn(*(a[i] if bt else a for a, bt in zip(args, batched)))
           for i in range(p)]
    return [torch.stack(x) for x in zip(*per)]


def _subround(args, p, consts):
    from .subround import ops, ref

    s, f, j = consts
    if kernel_backend(args[0].device) == "ref":
        return _plain(lambda *a: ref.subround_ref(
            *a, queue_size=s, max_frags=f, max_serves=j), p, args,
            _SUBROUND_BASE)
    return list(ops.subround(*args, s, f, j, p=p))


def _cms(args, p, consts):
    from .cms import ops, ref

    (tile,) = consts
    hkey, mask, counts = args
    if kernel_backend(hkey.device) == "ref":
        return _plain(lambda h, m, c: ref.cms_update_query_fast(
            ops.rows_for(h, c.shape[-1]), m.to(torch.int32), c,
            block_b=tile), p, args, _CMS_BASE)
    return list(ops.update_query(ops.rows_for(hkey, counts.shape[-1]), mask,
                                 counts, tile, p))


def _hot_gather(args, p, consts):
    from .hot_gather import ops, ref

    if kernel_backend(args[0].device) == "ref":
        return _plain(ref.hot_gather_ref, p, args, _HOT_GATHER_BASE)
    return list(ops.hot_gather(*args, p=p))


def _reply_values(args, p, consts):
    from .reply_values import ops, ref

    f, pad = consts
    if kernel_backend(args[0].device) == "ref":
        return _plain(lambda *a: (ref.reply_values_ref(*a, f, pad),), p,
                      args, _REPLY_VALUES_BASE)
    return [ops.reply_values(*args, f, pad, p=p)]


def _server_enqueue(args, p, consts):
    from .server_enqueue import ops, ref

    if kernel_backend(args[0].device) == "ref":
        return _plain(ref.server_enqueue_ref, p, args, _SERVER_ENQUEUE_BASE)
    rings, *rest = ops.server_enqueue(args[0], args[1], args[2:10],
                                      args[10:18], args[18], args[19], p=p)
    return [*rings, *rest]


# ---------------------------------------------------------------------------
# the fleet: custom ops whose batching rule launches once for all points
# ---------------------------------------------------------------------------
def _batched(*xs) -> bool:
    """Whether any argument is a tensor batched by ``torch.func.vmap``."""
    return any(isinstance(x, torch.Tensor) and is_batchedtensor(x)
               for x in xs)


def _call(op, points, args, consts):
    """A dispatcher's call: its custom op where vmap batches an input, else
    its points function for one instance."""
    if _batched(*args):
        return op(args, consts)
    return points(args, None, consts)


def _front(x, d):
    """A rule's input with its point axis first (``d`` None: shared)."""
    return x if d is None else x.movedim(d, 0)


def _unaliased(outs, ins):
    """A custom op may not return its inputs: copy any output that is
    one."""
    ptrs = {x.data_ptr() for x in ins if isinstance(x, torch.Tensor)}
    return [o.clone() if o.data_ptr() in ptrs else o for o in outs]


def _fold(q, p, args, dims, inner):
    """A points op's inputs under an outer vmap level of ``q`` points
    (``dims``: each input's axis of that level, or None): the ``[q * p,
    ...]`` inputs of one points op, an input shared by both levels kept as
    it is.  ``inner[k]``: input k has the op's own point axis (``p``)
    first."""
    out = []
    for a, d, bt in zip(args, dims, inner):
        if d is None and not bt:
            out.append(a)
            continue
        a = a.expand((q,) + a.shape) if d is None else a.movedim(d, 0)
        if not bt:
            a = a.unsqueeze(1).expand((q, p) + a.shape[1:])
        out.append(a.reshape((q * p,) + a.shape[2:]))
    return out


def _has_points(args, dims, base):
    """Whether each input carries the point axis: one dimension more than
    its ``base`` rank, not counting the vmap level's own (``dims``); a
    ``base`` of None always does."""
    return [n is None or a.dim() - (d is not None) > n
            for a, d, n in zip(args, dims, base)]


def _kernel_op(name, base, points):
    """Register kernel ``name``'s custom op ``repro_torch::<name>``, its
    points op ``repro_torch::<name>_points`` and a batching rule for each,
    around its points function ``points(args, p, consts)``; return the
    custom op.

    Both ops take the kernel's tensor inputs as one list and its int
    parameters as another.  ``base[k]`` is input k's rank in one
    instance, or None for an input the points op always takes per point:
    the custom op's rule expands it where the points share it."""

    @torch.library.custom_op(f"repro_torch::{name}", mutates_args=())
    def op(args: list[torch.Tensor], consts: list[int]) -> list[torch.Tensor]:
        return _unaliased(points(args, None, consts), args)

    @torch.library.custom_op(f"repro_torch::{name}_points", mutates_args=())
    def points_op(args: list[torch.Tensor], p: int,
                  consts: list[int]) -> list[torch.Tensor]:
        return _unaliased(points(args, p, consts), args)

    def op_vmap(info, in_dims, args, consts):
        p = info.batch_size
        args = [a.expand((p,) + a.shape) if d is None and n is None
                else _front(a, d) for a, d, n in zip(args, in_dims[0], base)]
        outs = points_op(args, p, consts)
        return outs, [0] * len(outs)

    def points_vmap(info, in_dims, args, p, consts):
        q, dims = info.batch_size, in_dims[0]
        args = _fold(q, p, args, dims, _has_points(args, dims, base))
        outs = points_op(args, q * p, consts)
        return [o.reshape((q, p) + o.shape[1:]) for o in outs], \
            [0] * len(outs)

    torch.library.register_vmap(op, op_vmap)
    torch.library.register_vmap(points_op, points_vmap)
    return op


# each input's rank in one instance (None: per point, always)
_SUBROUND_BASE = _subround_ops.BASE_RANKS
_CMS_BASE = (2, None, None)               # hkey; the sketches' mask, counts
_HOT_GATHER_BASE = (1, 1, 2)
_REPLY_VALUES_BASE = (2,) * 4
_SERVER_ENQUEUE_BASE = (1,) * 10 + (2,) * 8 + (1, 1)  # lanes; rings; counts

_subround_op = _kernel_op("subround", _SUBROUND_BASE, _subround)
_cms_op = _kernel_op("cms_update_query", _CMS_BASE, _cms)
_hot_gather_op = _kernel_op("hot_gather", _HOT_GATHER_BASE, _hot_gather)
_reply_values_op = _kernel_op("reply_values", _REPLY_VALUES_BASE,
                              _reply_values)
_server_enqueue_op = _kernel_op("server_enqueue", _SERVER_ENQUEUE_BASE,
                                _server_enqueue)
