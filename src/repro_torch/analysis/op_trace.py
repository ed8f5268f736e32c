"""Op traces of the port's bodies (counterpart of
``repro.analysis.jaxpr_walk``).

The reference walks the jaxpr of a traced chunk.  The port's chunks are
eager Python bodies (on the card captured once as CUDA graphs and
replayed), so the port records what a body *dispatches*:
:class:`OpRecorder` is a ``TorchDispatchMode`` that sees every aten op
below autograd and ``torch.func.vmap``, and :func:`trace` runs a callable
under it after one warm-up call.  Each :class:`OpRecord` carries the op,
its output dtypes and devices, the devices of its tensor inputs, the body
run it belongs to (``window[1]``: the counterpart of the reference's scan
depth) and its user site, ``name @ repro_torch/...:line``, the innermost
frame of this package that is not a kernel's.

Which entries use which recorder: every entry point and fixture uses this
dispatch-mode recorder, on the CPU and on the card.  ``torch.func.vmap``
(the fleet, the fabric's racks, the batched fabric's points) runs above
the Python dispatch key, so the recorder sees the batched ops vmap lowers
to; a ``repro_torch::*`` custom op arrives as one op, its body run with
the mode off.  A replayed CUDA graph dispatches nothing, so ops are
recorded from eager bodies (``graphs=False`` on the card); the graphs
themselves are read by :func:`repro_torch.analysis.profile.kernel_summary`.
``torch.profiler`` is not needed as a second recorder.

Skipped, as ``walk_eqns`` skips ``pallas_call`` bodies: every op whose
frames pass through ``repro_torch/kernels/`` (a kernel's wrapper, its
plain version on the ``ref`` backend, a batching rule) and every
``repro_torch::*`` op.  Those are the kernels' ops, held against the
kernels by their own tests, not the hot path's.
"""
from __future__ import annotations

import contextlib
import functools
import os
import pathlib
import sys
from typing import Callable, Iterable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_SRC = pathlib.Path(__file__).resolve().parents[2]          # .../src
_PKG = str(_SRC / "repro_torch") + "/"
_KERNELS = str(_SRC / "repro_torch" / "kernels") + "/"
_SELF = str(pathlib.Path(__file__).resolve())


class OpRecord(NamedTuple):
    op: str                    # e.g. "aten.scatter_add.default"
    out_dtypes: tuple          # of the tensor outputs
    out_devices: tuple
    in_devices: tuple          # of the tensor inputs, in argument order
    body: str | None           # "window", "period", "call"; None: outside
    index: int                 # the body run (0, 1, ...)
    position: int              # the op's place in that run
    site: str                  # "fn @ repro_torch/...:line" (innermost)
    frames: tuple              # user function names, innermost first
    args: dict                 # the op's non-tensor arguments, by name

    @property
    def path(self) -> str:
        return f"{self.body}[{self.index}]/op[{self.position}]"


def _tensors(x) -> Iterable[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _named_args(func, args, kwargs) -> dict:
    """The op's non-tensor arguments by schema name (``accumulate``,
    ``reduce``, ``device``, ...)."""
    names = [a.name for a in func._schema.arguments]
    out = {n: v for n, v in zip(names, args)
           if not isinstance(v, (torch.Tensor, list, tuple))}
    out.update({k: v for k, v in (kwargs or {}).items()
                if not isinstance(v, (torch.Tensor, list, tuple))})
    return out


@functools.lru_cache(maxsize=None)
def _real(filename: str) -> str:
    """A code object's file name, resolved (``sys.path`` may hold the
    package as ``tests/../src``)."""
    return os.path.realpath(filename)


def _user_frames(frame) -> tuple[list, bool]:
    """``([(name, path under src, line), ...] innermost first, whether a
    kernel's frame is among them)``."""
    out, in_kernel = [], False
    while frame is not None:
        fn = _real(frame.f_code.co_filename)
        if fn.startswith(_PKG) and fn != _SELF:
            if fn.startswith(_KERNELS):
                in_kernel = True
            out.append((frame.f_code.co_name, fn[len(str(_SRC)) + 1:],
                        frame.f_lineno))
        frame = frame.f_back
    return out, in_kernel


class OpRecorder(TorchDispatchMode):
    """Records every op dispatched while it is active (see the module
    docstring); :meth:`body` marks the body runs."""

    def __init__(self):
        super().__init__()
        self.records: list[OpRecord] = []
        self._body: str | None = None
        self._runs: dict[str, int] = {}
        self._pos = 0

    @contextlib.contextmanager
    def body(self, name: str):
        outer = (self._body, self._pos)
        self._body, self._pos = name, 0
        self._runs[name] = self._runs.get(name, -1) + 1
        try:
            yield
        finally:
            self._body, self._pos = outer

    def wrap(self, name: str, fn: Callable) -> Callable:
        def body(*a, **k):
            with self.body(name):
                return fn(*a, **k)
        return body

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "repro_torch":
            return out
        frames, in_kernel = _user_frames(sys._getframe(1))
        if in_kernel:
            return out
        site = f"{frames[0][0]} @ {frames[0][1]}:{frames[0][2]}" \
            if frames else ""
        outs = list(_tensors(out))
        self.records.append(OpRecord(
            op=str(func), out_dtypes=tuple(t.dtype for t in outs),
            out_devices=tuple(t.device for t in outs),
            in_devices=tuple(t.device for t in _tensors(list(args))),
            body=self._body,
            index=self._runs.get(self._body, 0) if self._body else 0,
            position=self._pos, site=site,
            frames=tuple(f[0] for f in frames),
            args=_named_args(func, args, kwargs)))
        if self._body is not None:
            self._pos += 1
        return out


_MISSING = object()


def trace(run: Callable[[], object], bodies=()) -> list[OpRecord]:
    """Call ``run()`` once unrecorded (a first call builds cached
    constants, ``core.types.device_const``), then once under an
    :class:`OpRecorder`.  ``bodies``: ``(object, attribute, name)`` of
    each body method ``run`` reaches (a chunk's ``window_body``, ...), each
    call a body run; with none, the whole of ``run()`` is one ``"call"``
    body."""
    run()
    rec = OpRecorder()
    saved = []
    for obj, attr, name in bodies:
        saved.append((obj, attr, obj.__dict__.get(attr, _MISSING)))
        setattr(obj, attr, rec.wrap(name, getattr(obj, attr)))
    try:
        with rec:
            if bodies:
                run()
            else:
                with rec.body("call"):
                    run()
    finally:
        for obj, attr, old in saved:
            if old is _MISSING:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)
    return rec.records


def in_bodies(records: list[OpRecord]) -> list[OpRecord]:
    """The records made inside a body run."""
    return [r for r in records if r.body is not None]
