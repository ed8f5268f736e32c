"""Core data types for the OrbitCache data plane (port of ``repro.core.types``).

Flat struct-of-arrays NamedTuples of tensors, with the reference's field
names and shapes.  Dtypes follow one rule, owned both ways by
:mod:`repro_torch.interop`:

* 128-bit key hashes are int32 tensors holding the reference's uint32 bit
  patterns (equality is all the data plane asks of them);
* the reference's uint32 lifetime counters are int64 tensors clamped at
  ``2**32 - 1`` by :func:`sat_add`;
* everything else keeps the reference dtype (int32, float32, bool, uint8).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

OP_R_REQ = 0    # read request
OP_W_REQ = 1    # write request
OP_R_REP = 2    # read reply (also the form cache packets take)
OP_W_REP = 3    # write reply
OP_F_REQ = 4    # fetch request (controller -> server)
OP_F_REP = 5    # fetch reply  (server -> switch, installs a cache packet)
OP_CRN_REQ = 6  # correction request (client-side hash-collision resolution)
OP_NONE = 7     # invalid / empty slot

ROUTE_DROP = 0     # absorbed by the switch
ROUTE_SERVER = 1   # forward to the owning storage server
ROUTE_CLIENT = 2   # forward to the client

HKEY_LANES = 4
DEFAULT_QUEUE_SIZE = 8

COUNTER_DTYPE = torch.int64
COUNTER_MAX = 2**32 - 1   # the reference counters are uint32

I32, F32 = torch.int32, torch.float32


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; only an explicit ``"cpu"`` runs there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=None)
def device_const(value, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """``torch.tensor(value, dtype, device)``, built once per (value, dtype,
    device) and never written: a window builds no tensor from host data, so
    it neither copies to the card nor waits for it, and a CUDA graph can
    capture it.  ``value`` keeps its own type (a ``np.float32`` stays that
    exact float32)."""
    return torch.tensor(value, dtype=dtype, device=device)


class PacketBatch(NamedTuple):
    """A batch of OrbitCache messages (struct of arrays, width ``B``)."""

    op: torch.Tensor        # int32[B]
    seq: torch.Tensor       # int32[B]
    hkey: torch.Tensor      # int32[B, 4] (uint32 bit patterns)
    flag: torch.Tensor      # int32[B]
    kidx: torch.Tensor      # int32[B]
    vlen: torch.Tensor      # int32[B]
    client: torch.Tensor    # int32[B]
    port: torch.Tensor      # int32[B]
    server: torch.Tensor    # int32[B]
    ts: torch.Tensor        # float32[B]
    valid: torch.Tensor     # bool[B]
    val: torch.Tensor       # uint8[B, value_pad]

    @property
    def width(self) -> int:
        return self.op.shape[0]


def empty_batch(width: int, value_pad: int = 1438, device=None) -> PacketBatch:
    d = resolve_device(device)
    full = lambda v: torch.full((width,), v, dtype=I32, device=d)
    return PacketBatch(
        op=full(OP_NONE), seq=full(0),
        hkey=torch.zeros((width, HKEY_LANES), dtype=I32, device=d),
        flag=full(0), kidx=full(-1), vlen=full(0), client=full(-1),
        port=full(0), server=full(-1),
        ts=torch.zeros((width,), dtype=F32, device=d),
        valid=torch.zeros((width,), dtype=torch.bool, device=d),
        val=torch.zeros((width, value_pad), dtype=torch.uint8, device=d),
    )


class LookupTable(NamedTuple):
    hkeys: torch.Tensor     # int32[C, 4]
    occupied: torch.Tensor  # bool[C]
    kidx: torch.Tensor      # int32[C]


class StateTable(NamedTuple):
    valid: torch.Tensor     # bool[C]
    version: torch.Tensor   # int32[C]


class RequestTable(NamedTuple):
    client: torch.Tensor    # int32[C * S]
    seq: torch.Tensor       # int32[C * S]
    port: torch.Tensor      # int32[C * S]
    ts: torch.Tensor        # float32[C * S]
    acked: torch.Tensor     # int32[C * S]
    kidx: torch.Tensor      # int32[C * S]
    qlen: torch.Tensor      # int32[C]
    front: torch.Tensor     # int32[C]
    rear: torch.Tensor      # int32[C]

    @property
    def num_entries(self) -> int:
        return self.qlen.shape[0]

    @property
    def queue_size(self) -> int:
        return self.client.shape[0] // self.qlen.shape[0]


class OrbitBuffer(NamedTuple):
    live: torch.Tensor      # bool[C * F]
    kidx: torch.Tensor      # int32[C * F]
    version: torch.Tensor   # int32[C * F]
    vlen: torch.Tensor      # int32[C * F]
    val: torch.Tensor       # uint8[C * F, value_pad]
    frags: torch.Tensor     # int32[C]

    @property
    def max_frags(self) -> int:
        return self.live.shape[0] // self.frags.shape[0]


class OrbitMeta(NamedTuple):
    """Orbit-line metadata without the value payload."""

    live: torch.Tensor
    kidx: torch.Tensor
    version: torch.Tensor
    vlen: torch.Tensor
    frags: torch.Tensor

    @property
    def max_frags(self) -> int:
        return self.live.shape[0] // self.frags.shape[0]


def sat_add(acc: torch.Tensor, delta) -> torch.Tensor:
    """Wrap-safe counter accumulate, saturating at ``2**32 - 1``.

    ``acc`` is an int64 counter holding a uint32 value; ``delta`` must be
    non-negative (a tensor of any integer dtype, or a Python int).
    """
    delta = torch.as_tensor(delta, device=acc.device).to(acc.dtype)
    return acc + torch.minimum(delta, COUNTER_MAX - acc)


class Counters(NamedTuple):
    popularity: torch.Tensor  # int64[C] (uint32 values)
    hits: torch.Tensor        # int64[]
    overflow: torch.Tensor    # int64[]
    cached_reqs: torch.Tensor # int64[]


class SwitchState(NamedTuple):
    lookup: LookupTable
    state: StateTable
    reqtab: RequestTable
    orbit: OrbitBuffer
    counters: Counters


def init_switch_state(num_entries: int, queue_size: int = DEFAULT_QUEUE_SIZE,
                      value_pad: int = 1438, max_frags: int = 1,
                      device=None) -> SwitchState:
    """Fresh, empty switch state with capacity for ``num_entries`` keys."""
    c, s, f = num_entries, queue_size, max_frags
    d = resolve_device(device)
    full = lambda n, v, dt=I32: torch.full((n,), v, dtype=dt, device=d)
    ctr = lambda *shape: torch.zeros(shape, dtype=COUNTER_DTYPE, device=d)
    return SwitchState(
        lookup=LookupTable(
            hkeys=torch.zeros((c, HKEY_LANES), dtype=I32, device=d),
            occupied=full(c, False, torch.bool), kidx=full(c, -1)),
        state=StateTable(valid=full(c, False, torch.bool), version=full(c, 0)),
        reqtab=RequestTable(
            client=full(c * s, -1), seq=full(c * s, 0), port=full(c * s, 0),
            ts=full(c * s, 0.0, F32), acked=full(c * s, 0),
            kidx=full(c * s, -1), qlen=full(c, 0), front=full(c, 0),
            rear=full(c, 0)),
        orbit=OrbitBuffer(
            live=full(c * f, False, torch.bool), kidx=full(c * f, -1),
            version=full(c * f, 0), vlen=full(c * f, 0),
            val=torch.zeros((c * f, value_pad), dtype=torch.uint8, device=d),
            frags=full(c, 1)),
        counters=Counters(popularity=ctr(c), hits=ctr(), overflow=ctr(),
                          cached_reqs=ctr()),
    )
