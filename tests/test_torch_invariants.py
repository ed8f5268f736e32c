"""Post-window structural invariants on the port, over native-draw traces
(``TorchDraws``), and the port's checker against the reference's.

The port of ``tests/test_invariants.py``: parity tests prove the port
equals the reference on replayed draws; these prove its states are
*right* under its own draws, where parity cannot reach (randomized load,
write mixes, controller churn, NetCache, a fleet's points, a fabric's
racks).  The checkers are library functions
(``repro_torch.analysis.invariants``) so that ``chip_smoke.py`` runs them
at the paper's scale; here the reference's own checkers
(``test_invariants._check_switch_invariants`` /
``_check_server_invariants``) and the port's must agree on a clean state
and on seeded violations built from a reference state.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from test_invariants import (  # noqa: E402
    _check_server_invariants, _check_switch_invariants,
)

from repro.core.types import init_switch_state as j_init_switch  # noqa: E402
from repro.kvstore import server as jsrv  # noqa: E402

from repro_torch.analysis.invariants import (  # noqa: E402
    InvariantViolation, check_netcache_invariants, check_server_invariants,
    check_switch_invariants, snapshot,
)
from repro_torch.core.types import (  # noqa: E402
    COUNTER_DTYPE, COUNTER_MAX, sat_add,
)
from repro_torch.interop import from_numpy  # noqa: E402
from repro_torch.kvstore import fabric_sim as tfs  # noqa: E402
from repro_torch.kvstore import fleet as tfl  # noqa: E402
from repro_torch.kvstore import simulator as tsim  # noqa: E402
from repro_torch.kvstore import workload as twl  # noqa: E402

CPU = torch.device("cpu")
RNG = np.random.default_rng(20260727)
RACK = dict(scheme="orbitcache", cache_entries=16, num_servers=2,
            client_batch=64, fetch_lanes=16, value_pad=64, server_queue=16,
            subrounds=2)


def workload(**kw):
    base = dict(num_keys=3_000, offered_rps=1.0e6)
    base.update(kw)
    return twl.Workload(twl.WorkloadConfig(**base), device=CPU)


@pytest.mark.parametrize("seed", [0, 1])
def test_orbitcache_invariants_over_randomized_trace(seed):
    """A random load / write-mix staircase; the invariants hold after
    every chunk, monotone against the chunk before."""
    rng = np.random.default_rng(seed)
    wl = workload(write_ratio=0.1)
    cfg = tsim.RackConfig(**RACK, seed=seed)
    sim = tsim.RackSimulator(cfg, wl, device=CPU)
    sim.preload(wl.hottest_keys(16))
    prev_sw = prev_srv = None
    for chunk in range(4):
        sim.set_offered(float(rng.uniform(0.3, 2.5)) * 1.0e6)
        sim.set_write_ratio(float(rng.uniform(0.0, 0.4)))
        sim.run_windows(4)
        sw = sim.carry.policy
        check_switch_invariants(sw, prev_sw, label=f"chunk {chunk}")
        check_server_invariants(sim.carry.servers, cfg, prev_srv,
                                label=f"chunk {chunk}")
        prev_sw, prev_srv = snapshot(sw), snapshot(sim.carry.servers)
    assert int(sw.counters.hits) > 0 and bool(sw.orbit.live.any())


def test_invariants_survive_controller_churn():
    """Cache updates (eviction and CacheIdx inheritance, §3.8) are the
    adversarial case for the one-line-per-key rule."""
    wl = workload()
    cfg = tsim.RackConfig(**RACK, track_popularity=True)
    sim = tsim.RackSimulator(cfg, wl, device=CPU)
    sim.preload(wl.hottest_keys(16))
    for period in range(3):
        sim.run_windows(4)
        sim._control_plane_update()
        sim.run_windows(4)
        # popularity resets at an update: no cross-period monotonicity
        check_switch_invariants(sim.carry.policy, None,
                                label=f"period {period}")
        check_server_invariants(sim.carry.servers, cfg, None,
                                label=f"period {period}")


def test_invariants_over_device_period_updates():
    """The device-side control plane (``run_periods``) keeps them too."""
    wl = workload()
    cfg = tsim.RackConfig(**RACK, track_popularity=True)
    sim = tsim.RackSimulator(cfg, wl, device=CPU)
    sim.preload(wl.hottest_keys(16))
    for p in range(3):
        if p:
            wl.hot_in_swap(8)
        sim.run_periods(1, 4)
        check_switch_invariants(sim.carry.policy, None, label=f"period {p}")


def test_netcache_invariants_over_randomized_trace():
    wl = workload()
    cfg = tsim.RackConfig(**dict(RACK, scheme="netcache"),
                          netcache_entries=500)
    sim = tsim.RackSimulator(cfg, wl, device=CPU)
    sim.preload(wl.hottest_keys(500))
    prev = prev_srv = None
    for chunk in range(3):
        sim.set_offered(float(RNG.uniform(0.3, 2.0)) * 1.0e6)
        sim.run_windows(4)
        st = sim.carry.policy
        check_netcache_invariants(st, prev, label=f"chunk {chunk}")
        check_server_invariants(sim.carry.servers, cfg, prev_srv,
                                label=f"chunk {chunk}")
        prev, prev_srv = snapshot(st), snapshot(sim.carry.servers)
    assert st.hits.dtype == COUNTER_DTYPE and int(st.hits) > 0


def test_fleet_points_keep_the_invariants():
    wl = workload(write_ratio=0.2)
    cfg = tsim.RackConfig(**RACK)
    fleet = tfl.BatchedRackSimulator(cfg, wl, offered_rps=(0.5e6, 2.0e6),
                                     seeds=(0, 1), device=CPU)
    fleet.preload()
    prev_sw = prev_srv = None
    for chunk in range(3):
        fleet.run_windows(4)
        check_switch_invariants(fleet.carry.policy, prev_sw,
                                label=f"fleet chunk {chunk}")
        check_server_invariants(fleet.carry.servers, cfg, prev_srv,
                                label=f"fleet chunk {chunk}")
        prev_sw = snapshot(fleet.carry.policy)
        prev_srv = snapshot(fleet.carry.servers)
    assert fleet.carry.policy.lookup.occupied.shape[0] == 2


def test_fabric_racks_keep_the_invariants():
    wl = workload(write_ratio=0.1)
    cfg = tsim.RackConfig(**RACK)
    fcfg = tfs.FabricConfig(n_racks=2, spine_cache_entries=16,
                            spine_lanes=16, fwd_lanes=16)
    sim = tfs.FabricSimulator(cfg, fcfg, wl, device=CPU)
    sim.preload(warm_windows=8)
    prev = None
    for chunk in range(3):
        sim.run_windows(4)
        c = sim.carry
        check_switch_invariants(c.racks.policy, prev and prev.racks.policy,
                                label=f"racks, chunk {chunk}")
        check_server_invariants(c.racks.servers, cfg,
                                prev and prev.racks.servers,
                                label=f"racks, chunk {chunk}")
        check_switch_invariants(c.spine, prev and prev.spine,
                                label=f"spine, chunk {chunk}")
        prev = snapshot(c)
    assert sim.carry.racks.policy.lookup.occupied.shape[0] == 2


def test_sat_add_counters_never_wrap_randomized():
    """``sat_add`` fuzz: random accumulate sequences clamp at the ceiling
    and are monotone, int32 deltas up to 2**31 - 1 included."""
    top = COUNTER_MAX
    for trial in range(50):
        rng = np.random.default_rng(1000 + trial)
        start = int(rng.integers(0, top, dtype=np.uint64))
        acc = torch.tensor(start, dtype=COUNTER_DTYPE)
        model = start
        for _ in range(8):
            delta = int(rng.integers(0, 2**31 - 1))
            acc = sat_add(acc, torch.tensor(delta, dtype=torch.int32))
            model = min(model + delta, top)
            assert acc.dtype == COUNTER_DTYPE
            assert int(acc) == model, f"trial {trial}: diverged"


# ---------------------------------------------------------------------------
# the reference's checkers against the port's
# ---------------------------------------------------------------------------
def _reference_switch():
    """A small reference switch state: 4 cached keys with live lines,
    queues in the pointer algebra."""
    sw = jax.tree.map(np.array, j_init_switch(8, queue_size=4, value_pad=8))
    lk, st, rt, ob, ctr = sw.lookup, sw.state, sw.reqtab, sw.orbit, \
        sw.counters
    keys = np.array([10, 11, 12, 13], np.int32)
    lk.occupied[:4] = True
    lk.kidx[:4] = keys
    st.valid[:4] = True
    st.version[:4] = [1, 2, 3, 4]
    ob.live[:4] = True
    ob.kidx[:4] = keys
    ob.version[:4] = [1, 2, 3, 4]
    rt.qlen[:4] = [2, 0, 1, 4]
    rt.front[:4] = [1, 0, 3, 2]
    rt.rear[:] = (rt.front + rt.qlen) % 4
    ctr.popularity[:4] = [5, 0, 7, 2**32 - 1]
    ctr.hits[...] = 9
    return sw


def _violate(case):
    """``(state, prev)`` of a reference switch for each case."""
    sw, prev = _reference_switch(), None
    if case == "two_live_lines":
        sw.orbit.kidx[1] = 10             # entry 1's line serves key 10 too
    elif case == "stale_live_line":
        sw.orbit.version[2] = 2           # the entry is at version 3
    elif case == "queue_pointers":
        sw.reqtab.rear[0] = (sw.reqtab.rear[0] + 1) % 4
    elif case == "live_on_invalid":
        sw.state.valid[3] = False
    elif case == "duplicate_keys":
        sw.lookup.kidx[1] = 10
        sw.orbit.live[1] = False
    elif case == "qlen_range":
        sw.reqtab.qlen[0] = 5
        sw.reqtab.rear[0] = (sw.reqtab.front[0] + 5) % 4
    elif case == "version_decreased":
        prev = _reference_switch()
        prev.state.version[0] = 2
    elif case == "counter_stepped_back":
        prev = _reference_switch()
        prev.counters.hits[...] = 10
    return sw, prev


def _raises(fn) -> bool:
    try:
        fn()
    except AssertionError:
        return True
    return False


SWITCH_CASES = ("clean", "two_live_lines", "stale_live_line",
                "queue_pointers", "live_on_invalid", "duplicate_keys",
                "qlen_range", "version_decreased", "counter_stepped_back")


@pytest.mark.parametrize("case", SWITCH_CASES)
def test_switch_checkers_agree(case):
    sw, prev = _violate(case)
    ref = _raises(lambda: _check_switch_invariants(sw, prev, label=case))
    port_sw = from_numpy(sw, CPU)
    port_prev = None if prev is None else snapshot(from_numpy(prev, CPU))
    port = _raises(lambda: check_switch_invariants(port_sw, port_prev,
                                                   label=case))
    assert ref == (case != "clean")
    assert port == ref, f"{case}: reference {ref}, port {port}"
    if port:
        with pytest.raises(InvariantViolation):
            check_switch_invariants(port_sw, port_prev, label=case)


@pytest.mark.parametrize("case", ("clean", "ring_pointers",
                                  "served_stepped_back"))
def test_server_checkers_agree(case):
    cfg = tsim.RackConfig(**RACK)
    scfg = jsrv.ServerConfig(num_servers=2, queue_depth=cfg.server_queue,
                             cap_per_window=2, value_pad=8)
    srv = jax.tree.map(np.array, jsrv.init_servers(scfg, num_keys=8))
    srv.qlen[:] = [3, 16]
    srv.front[:] = [14, 5]
    srv.rear[:] = (srv.front + srv.qlen) % cfg.server_queue
    srv.served[:] = [4, 2**32 - 1]
    prev = None
    if case == "ring_pointers":
        srv.rear[1] = (srv.rear[1] + 3) % cfg.server_queue
    elif case == "served_stepped_back":
        prev = jax.tree.map(np.array, srv)
        prev.served[0] = 5
    ref = _raises(lambda: _check_server_invariants(srv, cfg, prev))
    port_prev = None if prev is None else snapshot(from_numpy(prev, CPU))
    port = _raises(lambda: check_server_invariants(
        from_numpy(srv, CPU), cfg, port_prev))
    assert ref == (case != "clean") and port == ref


def test_fleet_violation_names_the_point():
    """A violation in one point of a stacked state names its index."""
    sw = from_numpy(_reference_switch(), CPU)
    bad = from_numpy(_violate("stale_live_line")[0], CPU)
    stacked = tsim.tree_stack([sw, bad])
    with pytest.raises(InvariantViolation, match=r"fleet\[1\]: stale"):
        check_switch_invariants(stacked, label="fleet")
