"""Clients (port of ``repro.kvstore.client``).

Open-loop Poisson request generation, orbit-served and server-served
reply accounting, and the client-side collision check that queues
correction requests.

Random draws come from an injectable source (the RNG seam): per window a
source supplies the Poisson count ``n`` and two flat uniform vectors
``u[b]`` (key ranks) and ``w[b]`` (write coin).  :class:`TorchDraws` makes
them with a ``torch.Generator`` on the device (Philox); :class:`ReplayDraws`
replays draws made elsewhere, such as ``jax.random``'s in a parity test.
A fleet of racks takes every point's draws before its vmapped window and
hands them in through :class:`GivenDraws`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.hashing import hash128_u32, server_of_key
from repro_torch.core.scatter_free import unique_writer
from repro_torch.core.types import (
    COUNTER_DTYPE, OP_CRN_REQ, OP_R_REP, OP_R_REQ, OP_W_REP, OP_W_REQ,
    PacketBatch, device_const, resolve_device, sat_add,
)

LAT_BUCKETS = 80
_LAT_BASE_US = 0.25
I32, F32 = torch.int32, torch.float32


def lat_bucket(lat_us: torch.Tensor) -> torch.Tensor:
    """Quarter-octave log bucket index (int32).

    ``log2`` runs in float64 and rounds once to float32, the correctly
    rounded float32 ``log2`` on every device and thread count.  Torch's
    float32 ``log2`` on the CPU is not reproducible: the first call in a
    process has returned values 6e-6 off on one thread's share of the
    input, moving latencies one bucket."""
    base = device_const(_LAT_BASE_US, F32, lat_us.device)
    x = torch.maximum(lat_us, base) / base
    log2x = torch.log2(x.to(torch.float64)).to(F32)
    return torch.clamp((4.0 * log2x).to(I32), 0, LAT_BUCKETS - 1)


def bucket_edges_us() -> np.ndarray:
    return _LAT_BASE_US * (2.0 ** (np.arange(LAT_BUCKETS + 1) / 4.0))


def _bucket_counts(bucket: torch.Tensor) -> torch.Tensor:
    """int64[LAT_BUCKETS] histogram increments; lanes with
    ``bucket == LAT_BUCKETS`` are dropped."""
    counts = torch.zeros(LAT_BUCKETS + 1, dtype=torch.int64,
                         device=bucket.device).scatter_add(
        0, bucket.reshape(-1).long(),
        torch.ones_like(bucket.reshape(-1), dtype=torch.int64))
    return counts[:LAT_BUCKETS]


class ClientConfig(NamedTuple):
    batch: int = 512
    num_clients: int = 4
    crn_width: int = 64
    base_rtt_us: float = 2.0
    value_pad: int = 1438
    subrounds: int = 1


class ClientState(NamedTuple):
    next_seq: torch.Tensor     # int32[]
    crn_kidx: torch.Tensor     # int32[crn_width]
    crn_n: torch.Tensor        # int32[]
    hist_switch: torch.Tensor  # int64[LAT_BUCKETS] (uint32 values)
    hist_server: torch.Tensor  # int64[LAT_BUCKETS]
    rx_switch: torch.Tensor    # int64[]
    rx_server: torch.Tensor    # int64[]
    tx: torch.Tensor           # int64[]
    mismatches: torch.Tensor   # int64[]


def init_clients(cfg: ClientConfig, device=None) -> ClientState:
    d = resolve_device(device)
    ctr = lambda *s: torch.zeros(s, dtype=COUNTER_DTYPE, device=d)
    return ClientState(
        next_seq=torch.zeros((), dtype=I32, device=d),
        crn_kidx=torch.full((cfg.crn_width,), -1, dtype=I32, device=d),
        crn_n=torch.zeros((), dtype=I32, device=d),
        hist_switch=ctr(LAT_BUCKETS), hist_server=ctr(LAT_BUCKETS),
        rx_switch=ctr(), rx_server=ctr(), tx=ctr(), mismatches=ctr(),
    )


class TorchDraws:
    """Per-window draws from a ``torch.Generator`` on ``device`` (Philox
    on CUDA): ``n ~ Poisson(offered)``, ``u, w ~ U[0, 1)``.

    A CUDA graph that draws from it registers ``gen`` (the simulator's
    chunk does), so each replay advances the generator as an eager
    window does."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def draw(self, offered: torch.Tensor, b: int):
        n = torch.poisson(offered.reshape(1).to(F32), generator=self.gen)[0]
        u = torch.rand(b, dtype=F32, device=self.device, generator=self.gen)
        w = torch.rand(b, dtype=F32, device=self.device, generator=self.gen)
        return n.to(torch.int64), u, w

    def reserve(self, n: int) -> None:
        """A generator never runs out."""

    def generators(self) -> list[torch.Generator]:
        """The generators a CUDA graph of a window must register."""
        return [self.gen]

    def get_state(self) -> torch.Tensor:
        return self.gen.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.gen.set_state(state)


class ReplayDraws:
    """Replays recorded draws: ``n`` int[W], ``u`` and ``w`` float32[W, b].

    The window to replay is a device index (``index``, int64[1]) that
    :meth:`draw` reads and advances on the device, so a captured window
    replays the next recorded one.  The host checks that enough windows
    are left before a chunk runs (:meth:`reserve`)."""

    def __init__(self, n, u, w, device):
        self.n = torch.as_tensor(np.asarray(n), device=device).to(torch.int64)
        self.u = torch.as_tensor(np.asarray(u, np.float32), device=device)
        self.w = torch.as_tensor(np.asarray(w, np.float32), device=device)
        self.index = torch.zeros(1, dtype=torch.int64, device=device)
        self.pos = 0            # windows reserved so far (host side)

    def reserve(self, n: int) -> None:
        """Claim the next ``n`` windows; raises if fewer are left."""
        if self.pos + n > self.n.shape[0]:
            raise IndexError(f"ReplayDraws: {n} windows asked for, "
                             f"{self.n.shape[0] - self.pos} of "
                             f"{self.n.shape[0]} left")
        self.pos += n

    def generators(self) -> list[torch.Generator]:
        return []

    def draw(self, offered: torch.Tensor, b: int):
        i = self.index
        n = self.n.index_select(0, i)[0]
        u = self.u.index_select(0, i)[0, :b]
        w = self.w.index_select(0, i)[0, :b]
        self.index += 1
        return n, u, w

    def get_state(self) -> tuple[torch.Tensor, int]:
        return self.index.clone(), self.pos

    def set_state(self, state: tuple[torch.Tensor, int]) -> None:
        self.index.copy_(state[0])
        self.pos = state[1]


class GivenDraws:
    """A source that returns the draws it was given: one window's ``(n,
    u, w)``, taken beforehand (the fleet draws every point's outside its
    vmapped window)."""

    def __init__(self, n, u, w):
        self.given = (n, u, w)

    def draw(self, offered: torch.Tensor, b: int):
        return self.given


def generate(st: ClientState, cfg: ClientConfig, draws, cdf: torch.Tensor,
             perm: torch.Tensor, vlen_table: torch.Tensor,
             offered_per_window: torch.Tensor, write_ratio: torch.Tensor,
             num_servers: int, now: torch.Tensor,
             ) -> tuple[ClientState, PacketBatch]:
    """One window of open-loop request generation (+ pending CRN drain),
    emitted subround-major ``[R, L]`` (logical lane ``j * R + r``)."""
    b = cfg.batch
    r_sub = cfg.subrounds
    if b % r_sub or cfg.crn_width % r_sub:
        raise ValueError(
            f"client batch ({b}) and crn_width ({cfg.crn_width}) must be "
            f"multiples of subrounds ({r_sub})")
    dev = cdf.device
    lc = b // r_sub
    n_draw, u_flat, w_flat = draws.draw(offered_per_window, b)
    n = torch.clamp(n_draw, max=b).to(I32)
    ar = lambda m: torch.arange(m, dtype=I32, device=dev)
    lane = ar(lc)[None, :] * r_sub + ar(r_sub)[:, None]
    valid = lane < n

    def ilv(x):  # flat [W, ...] -> [R, W // R, ...] in lane order
        return x.reshape((x.shape[0] // r_sub, r_sub) + x.shape[1:]
                         ).transpose(0, 1)

    ranks = torch.searchsorted(cdf, ilv(u_flat).contiguous())
    kidx = perm[torch.clamp(ranks, 0, perm.shape[0] - 1)]
    is_write = ilv(w_flat) < write_ratio
    seq = st.next_seq + lane
    op = torch.where(is_write, OP_W_REQ, OP_R_REQ)
    zeros = lambda w: torch.zeros((r_sub, w), dtype=I32, device=dev)

    pk = PacketBatch(
        op=torch.where(valid, op, 7).to(I32), seq=seq,
        hkey=hash128_u32(kidx), flag=zeros(lc), kidx=kidx,
        vlen=vlen_table[kidx.long()], client=seq % cfg.num_clients,
        port=zeros(lc), server=server_of_key(kidx, num_servers),
        ts=now.expand(r_sub, lc).to(F32), valid=valid,
        val=torch.zeros((r_sub, lc, cfg.value_pad), dtype=torch.uint8,
                        device=dev),
    )

    lcrn = cfg.crn_width // r_sub
    crn_lane = ar(lcrn)[None, :] * r_sub + ar(r_sub)[:, None]
    crn_valid = crn_lane < st.crn_n
    crn_kidx = torch.where(crn_valid, ilv(st.crn_kidx), 0)
    crn_seq = st.next_seq + b + crn_lane
    crn = PacketBatch(
        op=torch.where(crn_valid, OP_CRN_REQ, 7).to(I32), seq=crn_seq,
        hkey=hash128_u32(crn_kidx), flag=zeros(lcrn), kidx=crn_kidx,
        vlen=vlen_table[crn_kidx.long()], client=crn_seq % cfg.num_clients,
        port=zeros(lcrn), server=server_of_key(crn_kidx, num_servers),
        ts=now.expand(r_sub, lcrn).to(F32), valid=crn_valid,
        val=torch.zeros((r_sub, lcrn, cfg.value_pad), dtype=torch.uint8,
                        device=dev),
    )
    st = st._replace(
        next_seq=st.next_seq + (b + cfg.crn_width),
        crn_kidx=torch.full((cfg.crn_width,), -1, dtype=I32, device=dev),
        crn_n=torch.zeros((), dtype=I32, device=dev),
        tx=sat_add(st.tx, n),
    )
    batch = PacketBatch(*(torch.cat([a, c], dim=1) for a, c in zip(pk, crn)))
    return st, batch


def account_switch_served(st: ClientState, cfg: ClientConfig,
                          served: torch.Tensor, req_kidx: torch.Tensor,
                          ts: torch.Tensor, line_kidx: torch.Tensor,
                          serve_time: torch.Tensor) -> ClientState:
    """Account orbit-served replies; wrong-key serves queue CRN requests.

    ``served`` bool[C, J]; ``req_kidx`` int32[C, J]; ``ts`` and
    ``serve_time`` float32[C, J]; ``line_kidx`` int32[C].
    """
    f32 = lambda v: device_const(v, F32, served.device)
    lat = torch.maximum(serve_time - ts, f32(0.05)) + f32(cfg.base_rtt_us)
    bucket = torch.where(served, lat_bucket(lat), LAT_BUCKETS)
    hist = sat_add(st.hist_switch, _bucket_counts(bucket))
    n_served = torch.sum(served, dtype=I32)

    mism = served & (req_kidx != line_kidx[:, None])
    n_mism = torch.sum(mism, dtype=I32)
    flat_m = mism.reshape(-1)
    fm = flat_m.to(I32)
    order = torch.cumsum(fm, 0, dtype=I32) - fm
    dest = torch.where(flat_m, st.crn_n + order, cfg.crn_width)
    writer, written = unique_writer(dest, flat_m, cfg.crn_width)
    exp_flat = req_kidx.reshape(-1)
    crn_kidx = torch.where(written, exp_flat[writer], st.crn_kidx)
    crn_n = torch.clamp(st.crn_n + n_mism, max=cfg.crn_width)
    return st._replace(
        hist_switch=hist, rx_switch=sat_add(st.rx_switch, n_served),
        mismatches=sat_add(st.mismatches, n_mism),
        crn_kidx=crn_kidx, crn_n=crn_n.to(I32),
    )


def account_server_replies(st: ClientState, cfg: ClientConfig,
                           pkts: PacketBatch, to_client: torch.Tensor,
                           now: torch.Tensor) -> ClientState:
    """Account replies forwarded from storage servers (fragment 0 only)."""
    f32 = lambda v: device_const(v, F32, now.device)
    is_rep = (to_client & ((pkts.op == OP_R_REP) | (pkts.op == OP_W_REP))
              & (pkts.port == 0))
    lat = torch.maximum(now - pkts.ts, f32(0.05)) + f32(cfg.base_rtt_us)
    bucket = torch.where(is_rep, lat_bucket(lat), LAT_BUCKETS)
    return st._replace(
        hist_server=sat_add(st.hist_server, _bucket_counts(bucket)),
        rx_server=sat_add(st.rx_server, torch.sum(is_rep, dtype=I32)),
    )
