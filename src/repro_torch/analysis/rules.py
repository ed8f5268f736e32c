"""The lint rules and their allowlists (port of ``repro.analysis.rules``).

Every rule is registered in :data:`RULES` with the signature
``rule(entry: EntryPoint) -> list[Finding]``.  Op rules (``no-scatter``,
``no-host-sync``) read an :mod:`~repro_torch.analysis.op_trace` of the
entry's eager bodies; run rules drive the entry's harness as a user
would (graphed on the card) and are skipped for an entry whose harness
lacks what they need (a chunk, a swept axis).

=====================  =========================  ===========================
reference rule         port rule                  what it checks in the port
=====================  =========================  ===========================
no-scatter             no-scatter                 no scatter / index_put /
                                                  index_add / index_copy in
                                                  a body, but at allowlisted
                                                  sites
single-pallas-call     kernel-launches            dispatcher calls and kernel
                                                  launches of one run; on the
                                                  card the profiler's kernels
dtype-promotion        counter-saturation         counter leaves stay
                                                  ``COUNTER_DTYPE`` and clamp
no-dynamic-cond-...    no-host-sync               no op that reads the device
                                                  from the host or copies
                                                  between host and device
donation               carry-in-place             a chunk's carry keeps its
                                                  memory
retrace-guard          recapture-guard            sweeping a documented axis
                                                  captures no new graph
=====================  =========================  ===========================

Allowlists name *user functions*: a flagged op is forgiven when its site
(the innermost frame of this package, ``op_trace.OpRecord.site``) is a
function named in the rule's set.  Adding one is a reviewed change to this
file, justified in ``analysis/README.md``.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as kn
from repro_torch.core.types import COUNTER_DTYPE, COUNTER_MAX

from .findings import Finding, Severity
from .op_trace import in_bodies, trace

RULES: dict = {}

# Reviewed exceptions (rationale in README.md):
#   no-scatter: writes whose result does not depend on the order of the
#     lanes (integer adds, max):
#     _bucket_counts — the latency histogram's integer scatter-add;
#     last_writer — the port's single-writer algebra (``scatter_reduce``
#       amax of lane numbers, the reference's one-hot argmax);
#     server_step — the store-side key_version integer scatter-add, in
#       place in a chunk's donated table (the reference allowlists it);
#     merge_candidates_hashed — the server sketch's per-slot max estimate,
#       ``scatter_reduce`` amax (the reference's ``.at[slot].max``, under
#       its allowlisted ``server_step``);
#     netcache_step — NetCache's version bumps, an integer scatter-add
#       (the reference allowlists it).
#   no-scatter-unique: order-dependent writes whose indices are unique:
#     _write_row_ — a chunk's per-window metric row, ONE index.
ALLOWLISTS: dict = {
    "no-scatter": frozenset({
        "_bucket_counts", "last_writer", "server_step",
        "merge_candidates_hashed", "netcache_step",
    }),
    "no-scatter-unique": frozenset({"_write_row_"}),
    "no-host-sync": frozenset(),
}

def rule(name: str):
    def deco(fn):
        fn.rule_name = name
        RULES[name] = fn
        return fn
    return deco


def _allowlisted(rule_name: str, rec) -> bool:
    return bool(rec.frames) and rec.frames[0] in ALLOWLISTS.get(
        rule_name, frozenset())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def op_records(entry):
    """The op trace of one eager run of ``entry``'s bodies, after one
    warm-up run (cached on the entry)."""
    if "trace" not in entry._built:
        h = entry.harness(graphs=False)
        entry._built["trace"] = in_bodies(trace(h.run, h.bodies))
    return entry._built["trace"]


# ---------------------------------------------------------------------------
# op rules
# ---------------------------------------------------------------------------
_SCATTER_OPS = ("aten.scatter", "aten.index_put", "aten._index_put_impl",
                "aten.index_add", "aten.index_copy")
_ORDER_FREE_REDUCE = ("amax", "amin", "max", "min")


def write_mode(rec) -> str:
    """``"order-free"`` where the written values do not depend on the
    order in which lanes land (integer adds; max / min), else
    ``"order-dependent"``: an overwrite (``index_put`` without
    ``accumulate``, ``scatter`` of a ``src`` or value, ``index_copy``) or a
    float accumulate."""
    name = rec.op
    exact = all(not d.is_floating_point for d in rec.out_dtypes)
    if "scatter_add" in name or "index_add" in name:
        return "order-free" if exact else "order-dependent"
    if "index_put" in name:
        return ("order-free" if rec.args.get("accumulate") and exact
                else "order-dependent")
    reduce = rec.args.get("reduce")
    if reduce in _ORDER_FREE_REDUCE:
        return "order-free"
    if reduce in ("sum", "add", "prod", "multiply"):
        return "order-free" if exact else "order-dependent"
    return "order-dependent"


@rule("no-scatter")
def no_scatter(entry) -> list[Finding]:
    """No scatter, index_put, index_add or index_copy in a body.

    The reference's hot path is one-hot / unique-writer algebra by design;
    the port keeps scatters only where their result cannot depend on the
    order of the lanes, at reviewed sites.  An order-dependent write (an
    ``index_put_`` without accumulate, a ``scatter`` of values) stays
    flagged unless its site is reviewed for unique indices (ROADMAP Queue
    3: "never ``index_put_``")."""
    out = []
    for rec in op_records(entry):
        if not rec.op.startswith(_SCATTER_OPS):
            continue
        mode = write_mode(rec)
        if _allowlisted("no-scatter-unique", rec) or (
                mode == "order-free" and _allowlisted("no-scatter", rec)):
            continue
        out.append(Finding(
            rule="no-scatter", severity=Severity.ERROR, entry=entry.name,
            op=rec.op, path=rec.path, site=rec.site,
            message=(f"{mode} scatter in a {rec.body} body; use the "
                     f"one-hot / last_writer algebra or allowlist the "
                     f"site")))
    return out


_HOST_READ_OPS = (
    "aten._local_scalar_dense", "aten.is_nonzero", "aten.item",
    "aten.nonzero.", "aten.masked_select", "aten._unique", "aten.unique",
    "aten.equal", "aten.lift_fresh", "aten.allclose",
)


def host_transfer(rec) -> str:
    """Why ``rec`` reads the device from the host or builds a tensor from
    host data, or ``""``."""
    if rec.op.startswith(_HOST_READ_OPS):
        return "reads the device from the host" \
            if "lift_fresh" not in rec.op \
            else "builds a tensor from host data (torch.tensor)"
    if "cond" in rec.op.split("."):
        return "a data-dependent branch (cond)"
    if rec.op.startswith(("aten._to_copy", "aten.copy_")):
        devs = set(rec.in_devices) | set(rec.out_devices)
        if len({d.type for d in devs}) > 1:
            return (f"copies between "
                    f"{' and '.join(sorted(str(d) for d in devs))}")
    return ""


@rule("no-host-sync")
def no_host_sync(entry) -> list[Finding]:
    """No host read of the device, no host copy, in a body.

    After one warm-up run, no op in a body reads the device from the host
    or copies between host and device.  ``.item()``, ``bool(tensor)`` (a
    data-dependent Python branch), ``nonzero``, ``masked_select``,
    ``unique``, ``equal`` wait for the device; ``torch.tensor(...)``
    copies from the host; a CUDA graph can capture none of them, and every
    one stalls an eager window.  On the CPU this catches them before the
    card does."""
    out = []
    for rec in op_records(entry):
        why = host_transfer(rec)
        if not why or _allowlisted("no-host-sync", rec):
            continue
        out.append(Finding(
            rule="no-host-sync", severity=Severity.ERROR, entry=entry.name,
            op=rec.op, path=rec.path, site=rec.site,
            message=f"a {rec.body} body {why}; keep the window on the "
                    f"device (torch.where, device_const)"))
    return out


# ---------------------------------------------------------------------------
# run rules
# ---------------------------------------------------------------------------
@rule("kernel-launches")
def kernel_launches(entry) -> list[Finding]:
    """The architectural kernel count of one run, per backend.

    Every dispatcher call is one kernel of the reference (``CALLS``); on
    ``cuda`` each launches once (``LAUNCHES``), on ``ref`` none does.  More
    calls: a fused pass split; fewer: a path left the kernel.  On the card
    the profiler's count of each hand-written kernel must equal
    ``LAUNCHES``, and a replayed chunk copies nothing between host and
    device."""
    h = entry.harness()
    h.run()                                   # warm-up (captures graphs)
    _sync(entry.device)
    launches0, calls0 = dict(kn.LAUNCHES), dict(kn.CALLS)
    h.run()
    _sync(entry.device)
    launches = {k: kn.LAUNCHES[k] - launches0[k] for k in launches0}
    calls = {k: kn.CALLS[k] - calls0[k] for k in calls0}
    backend = kn.kernel_backend(entry.device)
    want_calls = {k: entry.calls.get(k, 0) for k in kn.CALLS}
    want_launches = want_calls if backend == "cuda" \
        else dict.fromkeys(want_calls, 0)
    out = []
    for k in kn.CALLS:
        for what, got, want in (("call", calls, want_calls),
                                ("launch", launches, want_launches)):
            if got[k] != want[k]:
                out.append(Finding(
                    rule="kernel-launches", severity=Severity.ERROR,
                    entry=entry.name, op=k, site=entry.site,
                    message=(f"{got[k]} {k} {what}(es) in one run on the "
                             f"'{backend}' backend, expected {want[k]}")))
    if entry.device.type == "cuda" and not out:
        out += _profiled_kernels(entry, h)
    return out


def _profiled_kernels(entry, h) -> list[Finding]:
    from .profile import KERNEL_SYMBOLS, kernel_summary

    summ = kernel_summary(h.run)
    out = []
    for k, sym in KERNEL_SYMBOLS.items():
        want, got = summ.launches[k], summ.kernels[sym]
        if got != want:
            out.append(Finding(
                rule="kernel-launches", severity=Severity.ERROR,
                entry=entry.name, op=sym, site=entry.site,
                message=(f"the profiler saw {got} {sym} in one run, "
                         f"LAUNCHES counted {want}")))
    if h.replayed and (summ.htod or summ.dtoh):
        out.append(Finding(
            rule="kernel-launches", severity=Severity.ERROR,
            entry=entry.name, op="memcpy", site=entry.site,
            message=(f"a replayed chunk copied between host and device: "
                     f"{summ.htod} HtoD, {summ.dtoh} DtoH")))
    return out


def leaves(tree, path="carry"):
    """``(path, tensor)`` of every tensor leaf of a tree of tuples."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or \
            [f"[{i}]" for i in range(len(tree))]
        for n, v in zip(names, tree):
            yield from leaves(v, f"{path}.{n}" if not n.startswith("[")
                              else f"{path}{n}")


def counter_leaves(tree) -> dict:
    """The counter leaves of a carry: every leaf of ``COUNTER_DTYPE`` (no
    other carry leaf has that dtype; README "Counters")."""
    return {p: t for p, t in leaves(tree) if t.dtype == COUNTER_DTYPE}


def _with_leaves(tree, values: dict, path="carry"):
    """``tree`` with the leaves at ``values``' paths replaced."""
    if isinstance(tree, torch.Tensor):
        return values.get(path, tree)
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None)
        items = [_with_leaves(v, values,
                              f"{path}.{n}" if names else f"{path}[{i}]")
                 for i, (n, v) in enumerate(zip(names or tree, tree))]
        return type(tree)(*items) if names else tuple(items)
    return tree


@rule("counter-saturation")
def counter_saturation(entry) -> list[Finding]:
    """Counters stay ``COUNTER_DTYPE`` and saturate at ``COUNTER_MAX``.

    The port's counters are int64 holding the reference's uint32 values,
    clamped by ``types.sat_add``; the footgun is a plain ``+`` into one.
    (a) every counter leaf of the input carry is a ``COUNTER_DTYPE`` leaf
    of the output; (b) with every counter leaf set to ``COUNTER_MAX - 1``,
    one window leaves each in ``[input, COUNTER_MAX]``."""
    h = entry.harness(graphs=False)
    if h.step is None:
        return []
    out = []

    def finding(path, message):
        out.append(Finding(rule="counter-saturation",
                           severity=Severity.ERROR, entry=entry.name,
                           path=path, site=entry.site, message=message))

    ctrs = counter_leaves(h.carry())
    got = dict(leaves(h.step(h.carry())))
    for p in ctrs:
        if p not in got or got[p].dtype != COUNTER_DTYPE:
            finding(p, f"counter leaf left {COUNTER_DTYPE} "
                       f"({got[p].dtype if p in got else 'missing'})")
    high = {p: torch.full_like(t, COUNTER_MAX - 1) for p, t in ctrs.items()}
    got = dict(leaves(h.step(_with_leaves(h.carry(), high))))
    for p, t in high.items():
        v = got.get(p)
        if v is None or v.dtype != COUNTER_DTYPE:
            continue
        if bool((v < t).any()) or bool((v > COUNTER_MAX).any()):
            finding(p, f"counter at COUNTER_MAX - 1 left [input, "
                       f"COUNTER_MAX] after one window: "
                       f"[{int(v.min())}, {int(v.max())}] (use "
                       f"types.sat_add)")
    return out


@rule("carry-in-place")
def carry_in_place(entry) -> list[Finding]:
    """A chunk returns its own buffers.

    The reference donates its carry; the port's chunk updates its
    key-version table in place and copies each window's other carry leaves
    back into buffers it owns, so every carry leaf keeps its ``data_ptr``
    over chunks 1, 2 and 3.  On the card the reserved memory
    and the graphs' pools do not grow from chunk 2 to chunk 3."""
    h = entry.harness()
    if h.state is None:
        return []
    ptrs, mem = [], []
    for _ in range(3):
        h.run()
        _sync(entry.device)
        ptrs.append({p: t.data_ptr() for p, t in leaves(h.state())})
        if entry.device.type == "cuda":
            mem.append((torch.cuda.memory_reserved(entry.device),
                        sum(getattr(h.chunk, "graph_bytes", {}).values())))
    out = []
    for p, ptr in ptrs[0].items():
        if any(later.get(p) != ptr for later in ptrs[1:]):
            out.append(Finding(
                rule="carry-in-place", severity=Severity.ERROR,
                entry=entry.name, path=p, site=entry.site,
                message="carry leaf rebound to new memory between chunks "
                        "(copy_ into the chunk's buffers)"))
    if mem and (mem[2][0] > mem[1][0] or mem[2][1] > mem[1][1]):
        out.append(Finding(
            rule="carry-in-place", severity=Severity.ERROR,
            entry=entry.name, site=entry.site,
            message=(f"memory grew from chunk 2 to chunk 3: reserved "
                     f"{mem[1][0]} -> {mem[2][0]} B, graph pools "
                     f"{mem[1][1]} -> {mem[2][1]} B")))
    return out


@rule("recapture-guard")
def recapture_guard(entry) -> list[Finding]:
    """Sweeping a documented axis does not capture a new graph.

    A chunk's graphs pay off only if host-side knob churn (offered load,
    ``active_size``, ``local_frac``) is copied into the captured buffers.
    The harness runs a chunk, sweeps the axis between chunks and checks
    ``CompiledChunk.captures``.  Card only: on the CPU a chunk captures
    nothing, so CPU entries offer no sweep and are skipped."""
    h = entry.harness()
    if h.sweep is None or not entry.sweep_values:
        return []
    h.run()
    before = h.chunk.captures
    for v in entry.sweep_values:
        h.sweep(v)
        h.run()
    _sync(entry.device)
    after = h.chunk.captures
    if after == before:
        return []
    return [Finding(
        rule="recapture-guard", severity=Severity.ERROR, entry=entry.name,
        site=entry.site,
        message=(f"sweeping '{entry.axis}' over {entry.sweep_values} "
                 f"captured {after - before} new graph(s); the axis leaked "
                 f"into the graph's key"))]
