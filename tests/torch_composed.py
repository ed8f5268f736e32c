"""The composed switch path of the port, the fused path's second oracle.

The port's counterpart of the composed seed step and window of
``tests/test_switch_regression.py``: each subround's switch pass is built
from the separate modules (``lookup.lookup``, a validity check, a
popularity scatter-add, ``request_table.enqueue``, the state table's
invalidate and validate, ``orbit.install_lines`` with the value bytes
written at once, ``orbit.orbit_pass``), and the window scans it over the
full ``SwitchState``.  The fused path (``core/pipeline.py``, one
``kernels.subround`` launch a subround on the card) must equal it leaf for
leaf.  Plain PyTorch only: it imports neither ``jax`` nor the reference,
runs on any device, and ``chip_smoke.py`` runs it on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.baselines import netcache_step, nocache_step
from repro_torch.core import lookup as lk
from repro_torch.core import orbit as ob
from repro_torch.core import pipeline
from repro_torch.core import request_table as rt
from repro_torch.core import state_table as stt
from repro_torch.core.controller import CacheController, ControllerConfig
from repro_torch.core.hashing import hash128_u32
from repro_torch.core.switch import StepOutput, StepStats, switch_step
from repro_torch.core.types import (
    OP_CRN_REQ, OP_F_REP, OP_F_REQ, OP_NONE, OP_R_REP, OP_R_REQ, OP_W_REP,
    OP_W_REQ, ROUTE_CLIENT, ROUTE_DROP, ROUTE_SERVER, Counters, PacketBatch,
    SwitchState, device_const, empty_batch, init_switch_state, sat_add,
)
from repro_torch.kvstore import client as cl
from repro_torch.kvstore import simulator as sim_mod
from repro_torch.kvstore.server import server_step
from repro_torch.kvstore.store import synth_value

I32, F32 = torch.int32, torch.float32
U32_MASK = 0xFFFFFFFF


def _count(mask):
    return torch.sum(mask, dtype=I32)


def seed_switch_step(sw: SwitchState, pkts: PacketBatch,
                     recirc_packets: torch.Tensor, max_serves: int,
                     ) -> tuple[SwitchState, StepOutput]:
    """One ingress batch + one serving round, composed from the modules."""
    op, valid = pkts.op, pkts.valid
    cidx = lk.lookup(sw.lookup, pkts.hkey)
    hit = (cidx >= 0) & valid
    safe_cidx = torch.where(hit, cidx, 0)

    r_req = valid & (op == OP_R_REQ)
    w_req = valid & (op == OP_W_REQ)
    r_rep = valid & (op == OP_R_REP)
    w_rep = valid & (op == OP_W_REP)
    f_rep = valid & (op == OP_F_REP)
    f_req = valid & (op == OP_F_REQ)
    crn = valid & (op == OP_CRN_REQ)

    r_hit = r_req & hit
    entry_valid = sw.state.valid[safe_cidx.long()] & hit
    enq = rt.enqueue(sw.reqtab, cidx, r_hit & entry_valid, pkts.client,
                     pkts.seq, pkts.port, pkts.ts, kidx=pkts.kidx)
    invalid_fwd = r_hit & ~entry_valid

    # the seed's popularity is a uint32 scatter-add, which wraps
    c = sw.counters.popularity.shape[0]
    pop_idx = torch.where(r_hit, cidx, c).long()
    adds = torch.zeros(c + 1, dtype=torch.int64, device=cidx.device
                       ).scatter_add(0, pop_idx, torch.ones_like(pop_idx))
    popularity = (sw.counters.popularity + adds[:c]) & U32_MASK
    n_hit, n_overflow = _count(r_hit), _count(enq.overflow)
    n_invalid_fwd = _count(invalid_fwd)

    w_cached = w_req & hit
    state2 = stt.invalidate(sw.state, safe_cidx, w_cached)
    flag_out = torch.where(w_cached, 1, pkts.flag).to(I32)

    install = (w_rep | f_rep) & hit & (pkts.flag >= 1)
    state3 = stt.validate(state2, safe_cidx, install)
    orbit2 = ob.install_lines(
        sw.orbit, safe_cidx, install, pkts.kidx,
        state3.version[safe_cidx.long()], pkts.vlen, pkts.val,
        frag=torch.where(f_rep, pkts.seq, 0),
        n_frags=torch.clamp(pkts.flag, min=1))

    ctr = sw.counters
    counters = Counters(
        popularity=popularity,
        hits=sat_add(ctr.hits, n_hit),
        overflow=sat_add(ctr.overflow, n_overflow + n_invalid_fwd),
        cached_reqs=sat_add(ctr.cached_reqs, n_hit),
    )
    sw2 = SwitchState(lookup=sw.lookup, state=state3, reqtab=enq.table,
                      orbit=orbit2, counters=counters)

    sw3, grid = ob.orbit_pass(sw2, recirc_packets, max_serves)
    bytes_served = torch.sum(torch.where(grid.served, grid.vlen[:, None], 0),
                             dtype=I32).to(torch.int64) & U32_MASK

    to_server = (r_req & ~hit) | enq.overflow | invalid_fwd | w_req | crn \
        | f_req
    to_client = r_rep | w_rep
    route = torch.full_like(op, ROUTE_DROP)
    route = torch.where(to_server & valid, ROUTE_SERVER, route)
    route = torch.where(to_client & valid, ROUTE_CLIENT, route).to(I32)

    stats = StepStats(
        n_r_req=_count(r_req), n_hit=n_hit, n_enq=_count(enq.accepted),
        n_overflow=n_overflow, n_invalid_fwd=n_invalid_fwd,
        n_w_req=_count(w_req), n_w_cached=_count(w_cached),
        n_install=_count(install), n_served=_count(grid.served),
        bytes_served=bytes_served, n_crn=_count(crn),
        n_fwd=_count(to_server & valid),
    )
    return sw3, StepOutput(route=route, flag=flag_out, grid=grid,
                           stats=stats)


def composed_window_step(cfg, server_cfg, client_cfg, key_size: int, wl,
                         carry):
    """A window whose switch is :func:`seed_switch_step` scanned over the
    subrounds on the full ``SwitchState`` (value bytes installed at once),
    with the client, server and routing stages of ``window_step``."""
    c = cfg
    clients, reqs, sub = sim_mod.generate_ingress(cfg, client_cfg, wl, carry)
    dev = sub.op.device
    f32 = lambda v: device_const(v, F32, dev)
    pad_to = sub.op.shape[0] * sub.op.shape[1]
    window = f32(c.window_us)
    isum = lambda x: torch.sum(x, dtype=I32)
    zero = lambda: torch.zeros((), dtype=I32, device=dev)
    switch_reply = torch.zeros(pad_to, dtype=torch.bool, device=dev)
    rows = lambda r: PacketBatch(*(a[r] for a in sub))

    if c.scheme == "orbitcache":
        sw, outs, intervals = carry.policy, [], []
        for r in range(c.subrounds):
            # the budget's float32 operations as XLA compiles the
            # reference's composed window (ROADMAP Queue 3)
            budget, interval_us = pipeline.recirc_budget(
                sw.orbit.live, sw.orbit.vlen, recirc_gbps=c.recirc_gbps,
                window_us=c.window_us, subrounds=c.subrounds,
                key_size=key_size)
            sw, out = seed_switch_step(sw, rows(r), budget, c.max_serves)
            outs.append(out)
            intervals.append(interval_us)
        policy = sw
        outs = pipeline._stack(outs)
        routes, flags, grids, stats = outs
        intervals = torch.stack(intervals)
        r_idx = torch.arange(c.subrounds, dtype=F32, device=dev)[:, None, None]
        k_sub = np.float32(c.window_us) * (np.float32(1.0)
                                           / np.float32(c.subrounds))
        serve_time = ((carry.now + (r_idx + f32(0.5)) * f32(k_sub))
                      + (grids.order.to(F32) + f32(1.0))
                      * intervals[:, None, None])
        j = c.max_serves
        clients = cl.account_switch_served(
            clients, client_cfg, grids.served.reshape(-1, j),
            grids.req_kidx.reshape(-1, j), grids.ts.reshape(-1, j),
            grids.kidx.reshape(-1), serve_time.reshape(-1, j))
        hits, installs = isum(stats.n_hit), isum(stats.n_install)
        overflow = isum(stats.n_overflow) + isum(stats.n_invalid_fwd)
        crn, rx_sw = isum(stats.n_crn), isum(stats.n_served)
    elif c.scheme == "netcache":
        policy, ys = carry.policy, []
        for r in range(c.subrounds):
            policy, *y = netcache_step(policy, rows(r))
            ys.append(y)
        routes, flags, sreps, n_hits = (torch.stack(x) for x in zip(*ys))
        switch_reply = sreps.reshape(-1)
        hits = isum(n_hits)
        overflow, installs, crn = zero(), zero(), zero()
        lat = (torch.full((pad_to,), 1.0, dtype=F32, device=dev)
               + f32(client_cfg.base_rtt_us))
        bucket = torch.where(switch_reply, cl.lat_bucket(lat), cl.LAT_BUCKETS)
        rx_sw = isum(switch_reply)
        clients = clients._replace(
            hist_switch=sat_add(clients.hist_switch,
                                cl._bucket_counts(bucket)),
            rx_switch=sat_add(clients.rx_switch, rx_sw))
    else:  # nocache
        policy, ys = carry.policy, []
        for r in range(c.subrounds):
            policy, *y = nocache_step(policy, rows(r))
            ys.append(y)
        routes, flags = (torch.stack(x) for x in zip(*ys))
        hits, overflow, installs, crn, rx_sw = (zero() for _ in range(5))

    route_flat, flag_flat = routes.reshape(-1), flags.reshape(-1)
    ing_flat = PacketBatch(*(a.reshape((pad_to,) + a.shape[2:]) for a in sub))
    to_server = (route_flat == ROUTE_SERVER) & ing_flat.valid
    servers, sout = server_step(carry.servers, server_cfg, ing_flat,
                                to_server, flag_flat, carry.now)
    to_client = (route_flat == ROUTE_CLIENT) & ing_flat.valid & ~switch_reply
    rx_srv_before = clients.rx_server
    clients = cl.account_server_replies(clients, client_cfg, ing_flat,
                                        to_client, carry.now + window)

    _, reply_pad = sim_mod._reply_width(cfg, server_cfg)
    rep = sout.replies
    if reply_pad:
        pad_b = empty_batch(reply_pad, c.value_pad, dev)
        rep = PacketBatch(*(torch.cat([a, p]) for a, p in zip(rep, pad_b)))

    metrics = sim_mod.WindowMetrics(
        tx=isum(reqs.valid & (reqs.op != OP_NONE)),
        rx_switch=rx_sw, rx_server=clients.rx_server - rx_srv_before,
        served=sout.served_now, dropped=sout.dropped_now,
        backlog=sout.backlog, hits=hits, overflow=overflow,
        installs=installs, crn=crn, mismatches=clients.mismatches,
        fwd=isum(to_server))
    new_carry = sim_mod.SimCarry(
        policy=policy, servers=servers, clients=clients,
        pending=sim_mod.interleave(rep, c.subrounds),
        fetch=sim_mod.interleave(empty_batch(c.fetch_lanes, c.value_pad, dev),
                                 c.subrounds),
        draws=carry.draws, now=carry.now + window, offered=carry.offered,
        write_ratio=carry.write_ratio)
    return new_carry, metrics


def fused_and_composed(sim, n_windows: int, compare):
    """Step ``sim``'s carry ``n_windows`` times through the fused
    ``window_step`` and through :func:`composed_window_step`, each window's
    draws taken once from ``sim``'s source and given to both; ``compare(
    fused, composed, label)`` is called on each window's metrics and carry
    and returns the leaves it compared.  Returns ``(leaves, carry)``."""
    from repro_torch.kvstore.client import GivenDraws
    args = (sim.cfg, sim.server_cfg, sim.client_cfg, sim.key_size,
            sim.wl.arrays)
    source = sim.carry.draws
    carry_a = carry_b = sim.carry
    leaves = 0
    for w in range(n_windows):
        given = GivenDraws(*source.draw(carry_a.offered, sim.cfg.client_batch))
        carry_a, met_a = sim_mod.window_step(
            *args, carry_a._replace(draws=given))
        carry_b, met_b = composed_window_step(
            *args, carry_b._replace(draws=given))
        label = f"{sim.cfg.scheme} window {w}"
        leaves += compare(met_a, met_b, f"{label} metrics")
        leaves += compare(carry_a, carry_b, f"{label} carry")
    return leaves, carry_a


# ---------------------------------------------------------------------------
# the subround edge cases of tests/test_switch_regression.py
# ---------------------------------------------------------------------------
PAD = 64


def _set(pk, n, **fields):
    """``pk`` with its first ``n`` lanes of each field set."""
    out = {}
    for f, v in fields.items():
        a = getattr(pk, f).clone()
        a[:n] = v
        out[f] = a
    return pk._replace(**out)


def boot(device, keys=(0, 1, 2, 3), entries=8, max_frags=1):
    """A switch with ``keys`` installed by the controller, and the F-REP
    batch carrying their values (unless fragments are asked for)."""
    sw = init_switch_state(entries, queue_size=4, value_pad=PAD,
                           max_frags=max_frags, device=device)
    ctrl = CacheController(ControllerConfig(active_size=entries))
    sw, fetches = ctrl.preload(sw, np.asarray(keys, np.int32))
    ks = [k for k, _ in fetches]
    return sw, ks, frep(device, ks, [0] * len(ks), 1, vlen=32)


def frep(device, keys, frags, n_frags, vlen=24):
    """F-REPs of ``keys``, fragment ``frags`` of ``n_frags`` each."""
    k = torch.tensor(keys, dtype=I32, device=device)
    fr = torch.tensor(frags, dtype=I32, device=device)
    return _set(empty_batch(max(8, len(keys)), value_pad=PAD, device=device),
                len(keys), op=OP_F_REP, kidx=k, hkey=hash128_u32(k),
                seq=fr, flag=n_frags, vlen=vlen,
                val=synth_value(k, fr, PAD), valid=True)


def traffic(device, rng, b=24):
    """Mixed-op batch: hits, misses, writes, installs, CRN, dead lanes."""
    ops = rng.choice([OP_R_REQ, OP_R_REQ, OP_R_REQ, OP_W_REQ, OP_W_REP,
                      OP_F_REP, OP_CRN_REQ], size=b).astype(np.int32)
    kidx = rng.choice([0, 1, 2, 3, 7, 99, 1234], size=b).astype(np.int32)
    flags = rng.integers(0, 2, b).astype(np.int32)
    valid = rng.random(b) < 0.85
    t = lambda a: torch.from_numpy(a).to(device)
    k = t(kidx)
    return empty_batch(b, value_pad=PAD, device=device)._replace(
        op=t(ops), kidx=k, hkey=hash128_u32(k), flag=t(flags),
        seq=torch.arange(b, dtype=I32, device=device),
        client=torch.arange(b, dtype=I32, device=device) % 4,
        vlen=torch.full((b,), 32, dtype=I32, device=device),
        val=synth_value(k, torch.zeros_like(k), PAD), valid=t(valid),
        ts=torch.arange(b, dtype=F32, device=device))


def read_batch(device, keys, width=16, start_seq=0):
    k = torch.tensor(keys, dtype=I32, device=device)
    ar = torch.arange(len(keys), dtype=I32, device=device)
    return _set(empty_batch(max(width, len(keys)), value_pad=PAD,
                            device=device), len(keys),
                op=OP_R_REQ, kidx=k, hkey=hash128_u32(k), seq=ar + start_seq,
                client=ar % 4, ts=ar.to(F32), valid=True)


def edge_cases(device):
    """{name: (switch, [(packets, budget)], keys)}: zero recirculation
    budget, full request queues, multi-fragment lines (max_frags = 2, the
    third key with one fragment of two), all-invalid ingress."""
    rd = lambda *a, **k: read_batch(device, *a, **k)
    cases = {}
    sw, ks, pk = boot(device)
    cases["zero_budget"] = (sw, [(pk, 100)] + [
        (rd([0, 1, 1, 2, 3], start_seq=9 * i), 0) for i in range(3)], ks)
    flood = rd([0] * 10 + [1] * 6, width=16)
    cases["full_queues"] = (sw, [(pk, 100), (flood, 0), (flood, 0),
                                 (flood, 100), (rd([0, 1, 2]), 100)], ks)
    dead = traffic(device, np.random.default_rng(3))
    dead = dead._replace(valid=torch.zeros_like(dead.valid))
    cases["all_invalid"] = (sw, [(pk, 100), (rd([0, 1, 2, 3]), 0),
                                 (dead, 0), (dead, 100)], ks)
    sw, ks, _ = boot(device, keys=(0, 1, 2), max_frags=2)
    both = frep(device, [ks[0], ks[0], ks[1], ks[1]], [0, 1, 0, 1], 2)
    half = frep(device, [ks[2]], [0], 2)
    cases["multi_fragment"] = (sw, [(both, 100), (half, 100),
                                    (rd(ks * 2), 100), (rd(ks), 100)], ks)
    return cases


def run_compare(sw, steps, label, compare, max_serves=4):
    """``switch_step`` and :func:`seed_switch_step` over ``steps`` from
    ``sw``; ``compare(fused, composed, label)`` after each step returns
    the leaves it compared.  Returns ``(fused switch, leaves)``."""
    fused = composed = sw
    leaves = 0
    for i, (pk, budget) in enumerate(steps):
        b = torch.tensor(budget, dtype=I32, device=pk.op.device)
        fused, out_f = switch_step(fused, pk, b, max_serves)
        composed, out_c = seed_switch_step(composed, pk, b, max_serves)
        leaves += compare(out_f, out_c, f"{label} step {i} output")
        leaves += compare(fused, composed, f"{label} step {i} state")
    return fused, leaves
