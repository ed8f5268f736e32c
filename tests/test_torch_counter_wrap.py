"""Wrap safety of the port's lifetime counters (the port of
``tests/test_counter_wrap.py``).

The reference's uint32 counters are the port's int64 tensors clamped at
``COUNTER_MAX = 2**32 - 1`` by ``types.sat_add``.  One test per site pins
a counter just below the ceiling and checks that it clamps instead of
passing it: ``client.generate`` (``tx``), ``account_switch_served``,
``account_server_replies`` and ``server_step`` (``served`` /
``dropped``).  NetCache's accumulate sites, on a rack and on the spine,
run through the ``counter-saturation`` lint rule, which sets every
counter of the carry to ``COUNTER_MAX - 1`` and checks each after one
window.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.entry_points import (  # noqa: E402
    EntryPoint, Harness, clone_tree,
)
from repro_torch.analysis.rules import RULES, counter_leaves  # noqa: E402
from repro_torch.core.types import (  # noqa: E402
    COUNTER_DTYPE, COUNTER_MAX, OP_R_REP, OP_R_REQ, empty_batch,
)
from repro_torch.kvstore import client as cl  # noqa: E402
from repro_torch.kvstore import fabric_sim as tfs  # noqa: E402
from repro_torch.kvstore import simulator as tsim  # noqa: E402
from repro_torch.kvstore import workload as twl  # noqa: E402
from repro_torch.kvstore.server import (  # noqa: E402
    ServerConfig, init_servers, server_step,
)

CPU = torch.device("cpu")
TOP = COUNTER_MAX
I32 = torch.int32


def _near_top(st, **fields):
    return st._replace(**{
        k: torch.full(getattr(st, k).shape, v, dtype=COUNTER_DTYPE)
        for k, v in fields.items()})


def _client_cfg():
    return cl.ClientConfig(batch=8, crn_width=4, subrounds=1, value_pad=8)


# --- client.generate: tx ---------------------------------------------------
def test_generate_tx_saturates():
    cfg = _client_cfg()
    st = _near_top(cl.init_clients(cfg, CPU), tx=TOP - 2)
    nk = 16
    draws = cl.GivenDraws(torch.tensor(1000, dtype=torch.int64),
                          torch.rand(8), torch.rand(8))   # n >> batch
    st2, _ = cl.generate(
        st, cfg, draws, cdf=torch.linspace(1.0 / nk, 1.0, nk),
        perm=torch.arange(nk, dtype=I32),
        vlen_table=torch.full((nk,), 8, dtype=I32),
        offered_per_window=torch.tensor(1000.0),
        write_ratio=torch.tensor(0.0), num_servers=2, now=torch.tensor(0.0))
    assert st2.tx.dtype == COUNTER_DTYPE
    assert int(st2.tx) == TOP                       # clamped, not passed


# --- client.account_switch_served: rx_switch / mismatches / hist_switch -----
def test_account_switch_served_saturates():
    cfg = _client_cfg()
    st = _near_top(cl.init_clients(cfg, CPU), rx_switch=TOP - 1,
                   mismatches=TOP - 1, hist_switch=TOP - 1)
    st2 = cl.account_switch_served(
        st, cfg, torch.ones((2, 2), dtype=torch.bool),
        req_kidx=torch.zeros((2, 2), dtype=I32),
        ts=torch.zeros((2, 2)),
        line_kidx=torch.ones(2, dtype=I32),         # != req_kidx: mismatch
        serve_time=torch.ones((2, 2)))
    assert int(st2.rx_switch) == TOP
    assert int(st2.mismatches) == TOP
    assert st2.hist_switch.dtype == COUNTER_DTYPE
    assert int(st2.hist_switch.max()) == TOP        # bucket clamped
    assert int(st2.hist_switch.min()) == TOP - 1


# --- client.account_server_replies: rx_server / hist_server ------------------
def test_account_server_replies_saturates():
    cfg = _client_cfg()
    st = _near_top(cl.init_clients(cfg, CPU), rx_server=TOP - 1,
                   hist_server=TOP - 1)
    pk = empty_batch(4, value_pad=8, device=CPU)._replace(
        op=torch.full((4,), OP_R_REP, dtype=I32),
        valid=torch.ones(4, dtype=torch.bool))
    st2 = cl.account_server_replies(st, cfg, pk,
                                    torch.ones(4, dtype=torch.bool),
                                    torch.tensor(1.0))
    assert int(st2.rx_server) == TOP
    assert int(st2.hist_server.max()) == TOP


# --- server_step: served / dropped -------------------------------------------
def test_server_counters_saturate():
    cfg = ServerConfig(num_servers=1, queue_depth=2, cap_per_window=2,
                       value_pad=8, max_frags=1)
    st = init_servers(cfg, num_keys=4, device=CPU)
    st = st._replace(served=torch.full((1,), TOP - 1, dtype=COUNTER_DTYPE),
                     dropped=torch.full((1,), TOP - 1, dtype=COUNTER_DTYPE))
    pk = empty_batch(4, value_pad=8, device=CPU)._replace(
        op=torch.full((4,), OP_R_REQ, dtype=I32),
        kidx=torch.arange(4, dtype=I32) % 4,
        vlen=torch.full((4,), 4, dtype=I32),
        server=torch.zeros(4, dtype=I32),
        valid=torch.ones(4, dtype=torch.bool))
    on = torch.ones(4, dtype=torch.bool)
    flags = torch.zeros(4, dtype=I32)
    st2, out = server_step(st, cfg, pk, on, flags, torch.tensor(0.0))
    assert int(out.dropped_now[0]) == 2             # 4 arrivals, depth 2
    assert int(out.served_now[0]) == 2
    assert int(st2.dropped[0]) == TOP               # TOP - 1 + 2, clamped
    assert int(st2.served[0]) == TOP
    # monotone under pressure on a second window too
    st3, _ = server_step(st2, cfg, pk, on, flags, torch.tensor(100.0))
    assert int(st3.served[0]) == TOP and int(st3.dropped[0]) == TOP


# --- NetCache's accumulate sites, through the counter-saturation rule --------
def _rule_findings(name, step, carry):
    entry = EntryPoint(name, lambda dev, graphs: Harness(
        run=lambda: step(clone_tree(carry)), step=step,
        carry=lambda: clone_tree(carry)), {}, CPU, body_fn=step)
    return RULES["counter-saturation"](entry)


def _workload():
    return twl.Workload(twl.WorkloadConfig(num_keys=64, offered_rps=1e6),
                        device=CPU)


def test_netcache_window_accounting_saturates():
    cfg = tsim.RackConfig(scheme="netcache", cache_entries=8, num_servers=2,
                          client_batch=16, fetch_lanes=8, value_pad=64,
                          server_queue=8, subrounds=2, max_serves=4,
                          queue_size=4, netcache_entries=16,
                          netcache_table=1 << 8)
    wl = _workload()
    sim = tsim.RackSimulator(cfg, wl, device=CPU)
    sim.preload(wl.hottest_keys(16))

    def step(carry):
        return tsim.window_step(cfg, sim.server_cfg, sim.client_cfg,
                                wl.cfg.key_size, wl.arrays, carry)[0]

    found = _rule_findings("netcache.window_step", step, sim.carry)
    assert found == [], "\n".join(f.format() for f in found)
    # the hit counter is one of the counters the rule pinned, and it moves
    assert int(step(clone_tree(sim.carry)).policy.hits) > 0


def test_netcache_spine_accounting_saturates():
    cfg = tsim.RackConfig(scheme="orbitcache", cache_entries=8,
                          num_servers=2, client_batch=16, fetch_lanes=8,
                          value_pad=64, server_queue=8, subrounds=2,
                          max_serves=4, queue_size=4)
    fcfg = tfs.FabricConfig(n_racks=2, spine_scheme="netcache",
                            spine_lanes=8, fwd_lanes=8,
                            spine_netcache_entries=16,
                            spine_netcache_table=1 << 8)
    wl = _workload()
    fsim = tfs.FabricSimulator(cfg, fcfg, wl, device=CPU)
    fsim.preload()

    def step(carry):
        return tfs.fabric_window_step(cfg, fcfg, fsim.server_cfg,
                                      fsim.client_cfg, wl.cfg.key_size,
                                      wl.arrays, carry)[0]

    found = _rule_findings("fabric.netcache_spine", step, fsim.carry)
    assert found == [], "\n".join(f.format() for f in found)
    assert "carry.spine.hits" in counter_leaves(fsim.carry)
