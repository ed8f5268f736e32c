"""Static cost of one step from an op trace (the port's counterpart of
``repro.launch.hlo_analysis``, which parses optimized HLO text).

This module reads no HLO: nothing here is compiled.  :class:`OpTrace` is
a ``TorchDispatchMode`` that sees every ATen op a function runs, on meta
tensors as readily as on real ones.  Under DTensor it lets the
DTensor op run first (it returns ``NotImplemented`` for a DTensor op, as
``CommDebugMode`` does) and then sees the per-device local ops and the
functional collectives DTensor inserts, so every count is per device, as
the reference's per-device SPMD program is.  Ops on ``FakeTensor``s are
DTensor's own shape propagation (it runs each new op once at the global
shapes) and are not counted: trace on meta or real tensors.  The reference's rules:

  * dot FLOPs: 2 x out elements x contraction, for ``mm`` / ``bmm`` /
    ``addmm`` / ``baddbmm`` (what ``matmul``, ``einsum`` and ``linear``
    decompose into), as ``_dot_flops``; elementwise FLOPs are ignored;
  * HBM bytes: 2 x result bytes of every op that is not a view or a bare
    allocation.  In eager every op is a fusion boundary, so this is the
    reference's fusion-boundary model with one op per fusion; an in-place
    slot write (``index_put_``, ``copy_`` into a view, a scatter) counts
    the bytes written, not the buffer, as the reference's
    dynamic-update-slice rule does;
  * collective wire bytes: the ring factors of ``_collective_wire``
    applied to ``_c10d_functional.all_gather_into_tensor``,
    ``reduce_scatter_tensor``, ``all_reduce``, ``all_to_all_single`` and
    DTensor's ``shard_dim_alltoall``, each group's size read from its
    arguments.

A Python loop is unrolled in the trace, so trip counts need no parsing,
but a long recurrence (the sLSTM's time loop: 32,768 steps of ops on
DTensors for ``prefill_32k``) is slow to trace.  Its loop takes its
steps from :func:`recurrence`, and :func:`by_trip_count` traces a
stretch of it and counts the remaining steps, of the same ops on the
same shapes, by the trip count, as the reference's analyzer counts a
while body times its known trip count.
:class:`OpTrace` also follows the bytes of live local storages (each
op's new storages, released when the last tensor on them is, saved
autograd tensors included) and keeps their peak: the eager counterpart
of the reference's ``temp_size_in_bytes``.
``bf16_upcast_bytes`` is always 0: the reference subtracts the bf16 ->
f32 copies XLA:CPU inserts around bf16 collectives, and eager PyTorch
inserts none.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field, fields

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

_DOTS = {aten.mm.default: 0, aten.addmm.default: 1, aten.bmm.default: 0,
         aten.baddbmm.default: 1}
# ops that move no bytes on their own: allocations without a fill, alias
# and metadata ops, the wait on a collective's result
_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten.detach.default,
         aten.alias.default, aten.lift_fresh.default,
         aten._local_scalar_dense.default, aten.set_.source_Storage,
         aten.set_.source_Storage_storage_offset}
# in-place slot writes -> the argument whose bytes are written
_SLOT_WRITES = {aten.index_put_.default: 2, aten.index_put.default: 2,
                aten._index_put_impl_.default: 2, aten.copy_.default: 1,
                aten.scatter_.src: 3, aten.scatter.src: 3,
                aten.slice_scatter.default: 1,
                aten.select_scatter.default: 1}


def _collectives():
    import torch.distributed.tensor  # noqa: F401  (registers _dtensor ops)
    c10d = torch.ops._c10d_functional
    return {c10d.all_gather_into_tensor.default: ("all-gather", 1),
            c10d.reduce_scatter_tensor.default: ("reduce-scatter", 2),
            c10d.all_reduce.default: ("all-reduce", None),
            c10d.all_to_all_single.default: ("all-to-all", None),
            torch.ops._dtensor.shard_dim_alltoall.default: ("all-to-all",
                                                            None)}


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _is_fake(out) -> bool:
    return any(isinstance(t, FakeTensor) for t in tree_leaves(out))


def local_tensors(tree):
    """The plain tensors of ``tree``, a DTensor's local shard for it."""
    from torch.distributed.tensor import DTensor

    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            yield t


def _group_size(func, args, size_arg, default: int) -> int:
    if size_arg is not None:
        return int(args[size_arg])
    group = args[-1]
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        group = _resolve_process_group(group)
    return group.size() if hasattr(group, "size") else default


def _collective_wire(kind: str, out_b: int, g: int) -> float:
    """Per-device wire bytes (ring algorithm factors)."""
    if g <= 1:
        return 0.0
    f = (g - 1) / g
    if kind == "all-gather":
        return f * out_b                  # result assembled from g shards
    if kind == "all-reduce":
        return 2.0 * f * out_b            # reduce-scatter + all-gather
    if kind == "reduce-scatter":
        return f * out_b * g              # operand bytes = out * g
    if kind == "all-to-all":
        return f * out_b
    return float(out_b)


def _dot_flops(func, args, out) -> float:
    a = args[_DOTS[func]]               # the lhs: [..., M, K]
    return 2.0 * out.numel() * a.shape[-1]


@dataclass
class Analysis:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_wire_bytes: float = 0.0
    collective_bytes_by_kind: dict = field(default_factory=dict)
    collective_counts: dict = field(default_factory=dict)
    bf16_upcast_bytes: float = 0.0   # always 0 here (module docstring)
    ops: int = 0
    notes: list = field(default_factory=list)


class OpTrace(TorchDispatchMode):
    """Accumulates an :class:`Analysis` (``.analysis``) over the ops run
    inside ``with OpTrace(n_devices):``, the per-op records that
    :func:`top_contributors` ranks (``.records``: (kind, op, shape) ->
    [count, bytes]) and ``.peak_bytes``, the most bytes of storages that
    ops inside made and that were alive at once.  The storages of
    ``resident`` (a tree of tensors, such as the arguments) are not
    counted when an op writes them in place."""

    def __init__(self, n_devices: int = 1, resident=()):
        super().__init__()
        self.n_devices = n_devices
        self.analysis = Analysis()
        self.records: dict = {}
        self.live_bytes = self.peak_bytes = 0
        self._storages: dict = {}
        self._coll = _collectives()
        for t in local_tensors(resident):
            self._storages[t.untyped_storage()._cdata] = 0

    def _alloc(self, out):
        for t in local_tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.live_bytes -= self._storages.pop(key, 0)

    def _record(self, kind, func, out, nbytes):
        key = (kind, str(func), tuple(getattr(out, "shape", ())))
        rec = self.records.setdefault(key, [0, nbytes])
        rec[0] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor desugars to local ops
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) or (
                not types and _is_fake(out)):
            return out                  # DTensor's shape propagation
        self._alloc(out)
        a = self.analysis
        a.ops += 1
        if func in self._coll:
            kind, size_arg = self._coll[func]
            rb = _nbytes(out)
            g = _group_size(func, args, size_arg, self.n_devices)
            a.collective_wire_bytes += _collective_wire(kind, rb, g)
            a.collective_bytes_by_kind[kind] = (
                a.collective_bytes_by_kind.get(kind, 0.0) + rb)
            a.collective_counts[kind] = a.collective_counts.get(kind, 0) + 1
            self._record("collective", func, out, rb)
            return out
        if func in _DOTS:
            a.flops += _dot_flops(func, args, out)
        if func in _FREE or func.is_view or func.namespace == "_c10d_functional":
            return out
        if func in _SLOT_WRITES:
            nb = _nbytes(args[_SLOT_WRITES[func]])
        else:
            nb = _nbytes(out)
        a.hbm_bytes += 2.0 * nb
        self._record("hbm", func, out, nb)
        return out


def analyze(fn, *args, n_devices: int = 1, **kwargs) -> Analysis:
    """Run ``fn(*args, **kwargs)`` under an :class:`OpTrace` and return its
    analysis."""
    with OpTrace(n_devices) as tr:
        fn(*args, **kwargs)
    return tr.analysis


def top_contributors(fn, *args, n: int = 12, n_devices: int = 1, **kwargs):
    """Profiler view: the largest (bytes x count) ops of ``fn``'s trace.

    Returns two lists (collectives, hbm) of dicts sorted by total bytes --
    the 'what do I fix next' view."""
    with OpTrace(n_devices) as tr:
        fn(*args, **kwargs)
    colls, hbms = [], []
    for (kind, op, shape), (count, nbytes) in tr.records.items():
        rec = dict(op=op, mult=count, bytes=nbytes, total=count * nbytes,
                   shape=list(shape))
        (colls if kind == "collective" else hbms).append(rec)
    colls.sort(key=lambda r: -r["total"])
    hbms.sort(key=lambda r: -r["total"])
    return colls[:n], hbms[:n]


# ---------------------------------------------------------------------------
# recurrences: a stretch traced, the other steps counted by the trip count
# ---------------------------------------------------------------------------
_STRETCH: dict | None = None      # set inside by_trip_count


def recurrence(n: int) -> range:
    """The steps of a time loop whose steps run the same ops on the same
    shapes: ``range(n)``.  Inside :func:`by_trip_count` only the first
    steps of a stretch run, and ``n`` is noted."""
    if _STRETCH is None:
        return range(n)
    _STRETCH["trips"].add(n)
    return range(min(n, _STRETCH["steps"]))


def _extrapolate(a, b, extra: int):
    """``a + extra * (b - a)`` of two traces (an :class:`OpTrace` and a
    dict of counts) that differ by one step of a recurrence."""
    lin = lambda x, y: x + extra * (y - x)   # noqa: E731

    def lin_dict(x, y):
        return {k: lin(x.get(k, 0), y.get(k, 0)) for k in {**x, **y}}

    (ta, ca), (tb, cb) = a, b
    out = OpTrace(ta.n_devices)
    for f in fields(Analysis):
        x, y = getattr(ta.analysis, f.name), getattr(tb.analysis, f.name)
        setattr(out.analysis, f.name, lin_dict(x, y) if isinstance(x, dict)
                else list(y) if isinstance(x, list) else lin(x, y))
    out.records = {k: [lin(ta.records.get(k, (0,))[0], rec[0]), rec[1]]
                   for k, rec in tb.records.items()}
    out.peak_bytes = max(ta.peak_bytes, tb.peak_bytes)
    return out, lin_dict(ca, cb)


def by_trip_count(trace, k: int = 2):
    """``trace()`` -> ``(OpTrace, {op: count})`` with every
    :func:`recurrence` cut to its first ``k + 1`` steps.  When a
    recurrence has more, ``trace()`` runs again with ``k`` and with ``k +
    1`` steps, and each count and byte total is the ``k``-step trace's
    plus ``n - k`` times the step between the two: exact when steps 2 to
    ``n - 1`` run the same ops (the first step's backward and the last's
    differ: no gradient flows into the initial state or out of the final
    one), as ``tests/test_torch_dryrun_archs.py`` holds against a full
    trace.  The first run warms DTensor's caches (on first sight of an
    op and layout it runs a few small ops of its own, which the trace
    counts), so the two compared runs are alike.  The live-storage peak
    is the stretch's, a lower bound (the steps not run save no
    activations).  A note in the analysis says so.  Every recurrence of
    one trace must have the same trip count."""
    def run(steps):
        global _STRETCH
        _STRETCH = {"steps": steps, "trips": set()}
        try:
            out = trace()
        finally:
            trips, _STRETCH = _STRETCH["trips"], None
        return out, trips

    first, trips = run(k + 1)
    if max(trips, default=0) <= k + 1:
        return first
    if len(trips) > 1:
        raise ValueError(f"recurrences of trip counts {sorted(trips)}")
    n = trips.pop()
    tr, counts = _extrapolate(run(k)[0], run(k + 1)[0], n - k)
    tr.analysis.notes.append(
        f"recurrence: steps 1-{k} and 1-{k + 1} of {n} traced; counts and "
        f"bytes extrapolated to {n} steps by the trip count; the temp peak "
        f"is the stretch's, a lower bound")
    return tr, counts
