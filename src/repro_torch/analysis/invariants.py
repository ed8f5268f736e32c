"""Post-window structural invariants of the port's state, as library
checks (port of the checkers in ``tests/test_invariants.py``).

Parity tests prove the port equals the reference; these prove a state is
*right*: properties the switch hardware guarantees by construction hold
after every window, whatever the draws (native ``TorchDraws`` runs
included):

* at most one live orbit line per key, and a live line belongs to an
  occupied, valid, version-current entry (the drop-stale rule, §3.7);
  occupied entries hold distinct keys;
* request-table queues within ``[0, S]`` and the circular-queue algebra
  ``rear == (front + qlen) mod S``; server FIFOs the same against their
  depth;
* versions monotone: state-table and store versions never step back;
* counters are ``COUNTER_DTYPE`` within ``[0, COUNTER_MAX]`` and monotone
  (saturating, never wrapping);
* NetCache: stored values within the hardware limit, its hit counter as
  above.

A state may carry leading axes (a fleet's points, a fabric's racks, both):
each instance is checked, and a violation names its index.  ``prev`` is
the state one or more windows earlier, as :func:`snapshot` took it (a
chunk overwrites its carry's buffers, so take the snapshot before the next
chunk).  A violation raises :class:`InvariantViolation`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import COUNTER_DTYPE, COUNTER_MAX

_COUNTER_NP = torch.empty((), dtype=COUNTER_DTYPE).numpy().dtype
SWITCH_COUNTERS = ("popularity", "hits", "overflow", "cached_reqs")


class InvariantViolation(AssertionError):
    """A post-window structural invariant does not hold."""


def snapshot(tree):
    """A host copy of every tensor leaf of a tree (numpy leaves)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).numpy()
    if isinstance(tree, tuple):
        items = [snapshot(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    return tree


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _require(ok, message: str) -> None:
    if not bool(ok):
        raise InvariantViolation(message)


def _check_counter(arr, before, what: str) -> None:
    _require(arr.dtype == _COUNTER_NP,
             f"{what}: {arr.dtype}, not the counter dtype {_COUNTER_NP}")
    _require(((arr >= 0) & (arr <= COUNTER_MAX)).all(),
             f"{what}: outside [0, COUNTER_MAX]")
    if before is not None:
        _require((arr >= _np(before)).all(),
                 f"{what}: stepped backwards (a wrap?)")


def _check_ring(qlen, front, rear, size: int, what: str) -> None:
    _require(((qlen >= 0) & (qlen <= size)).all(),
             f"{what}: qlen outside [0, {size}]")
    _require(((front >= 0) & (front < size)).all(),
             f"{what}: front outside [0, {size})")
    _require(((rear >= 0) & (rear < size)).all(),
             f"{what}: rear outside [0, {size})")
    _require((rear == (front + qlen) % size).all(),
             f"{what}: rear != (front + qlen) mod {size}")


def _check_one_switch(sw: dict, label: str) -> None:
    c, f = sw["occupied"].shape[0], sw["live"].shape[0] // \
        sw["occupied"].shape[0]
    occ, valid, version = sw["occupied"], sw["valid"], sw["version"]
    keys = sw["kidx"][occ]
    _require(len(set(keys.tolist())) == len(keys),
             f"{label}: occupied entries hold duplicate keys")
    live = sw["live"].reshape(c, f)
    okidx = sw["okidx"].reshape(c, f)
    over = sw["oversion"].reshape(c, f)
    served = okidx[:, 0][live[:, 0]]
    _require(len(set(served.tolist())) == len(served),
             f"{label}: a key has more than one live orbit line")
    for cc, ff in zip(*np.nonzero(live)):
        _require(occ[cc], f"{label}: live line on unoccupied entry {cc}")
        _require(valid[cc], f"{label}: live line on invalid entry {cc}")
        _require(over[cc, ff] == version[cc],
                 f"{label}: stale live line at entry {cc} frag {ff}")


def check_switch_invariants(sw, prev=None, label: str = "") -> None:
    """The OrbitCache switch state's invariants (``SwitchState``, or a
    stack of them with leading axes); ``prev`` an earlier
    :func:`snapshot` of the same state, for the monotone checks."""
    lk, st, rt, ob = sw.lookup, sw.state, sw.reqtab, sw.orbit
    arrs = dict(occupied=_np(lk.occupied), kidx=_np(lk.kidx),
                valid=_np(st.valid), version=_np(st.version),
                live=_np(ob.live), okidx=_np(ob.kidx),
                oversion=_np(ob.version))
    lead = arrs["occupied"].shape[:-1]
    for idx in np.ndindex(*lead):
        where = f"{label}{list(idx) if idx else ''}"
        _check_one_switch({k: v[idx] for k, v in arrs.items()}, where)
    qlen = _np(rt.qlen)
    s = _np(rt.client).shape[-1] // qlen.shape[-1]
    _check_ring(qlen, _np(rt.front), _np(rt.rear), s,
                f"{label}: request table")
    for name in SWITCH_COUNTERS:
        _check_counter(_np(getattr(sw.counters, name)),
                       None if prev is None else getattr(prev.counters, name),
                       f"{label}: counter {name}")
    if prev is not None:
        _require((arrs["version"] >= _np(prev.state.version)).all(),
                 f"{label}: state version decreased")


def check_server_invariants(servers, cfg, prev=None, label: str = "") -> None:
    """The storage servers' FIFO rings, store versions and counters
    (``ServerState`` with any leading axes; ``cfg`` a ``RackConfig`` or
    anything with ``server_queue``)."""
    _check_ring(_np(servers.qlen), _np(servers.front), _np(servers.rear),
                cfg.server_queue, f"{label}: server ring")
    for name in ("served", "dropped"):
        _check_counter(_np(getattr(servers, name)),
                       None if prev is None else getattr(prev, name),
                       f"{label}: server counter {name}")
    if prev is not None:
        _require((_np(servers.key_version)
                  >= _np(prev.key_version)).all(),
                 f"{label}: store version decreased")


def check_netcache_invariants(st, prev=None, label: str = "") -> None:
    """NetCache: stored values within the hardware limit, the hit counter
    saturating (``NetCacheState`` with any leading axes)."""
    vlen, limit = _np(st.vlen), st.val.shape[-1]
    _require(((vlen >= 0) & (vlen <= limit)).all(),
             f"{label}: NetCache stored a value beyond its limit {limit}")
    _check_counter(_np(st.hits), None if prev is None else prev.hits,
                   f"{label}: NetCache hits")
