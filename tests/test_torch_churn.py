"""Fig. 18 churn through the port fleet's device control plane (the port's
``tests/test_churn.py``).

``Workload.hot_in_swap`` makes the cached keys cold; the periodic cache
updates inside the fleet's chunks (server count-min reports, evictions,
inserts, F-REQs) re-learn the hot set.  The fleet is a batching transform:
point ``i`` equals the serial rack with the same draw source through
periods and a swap (traces, switch state, ``active_size``), and the port's
fleet equals the reference's ``BatchedRackSimulator.run_periods`` on the
reference's draws (traces, every stacked carry leaf, every period's
``TracedUpdate``, ``active_size``; the latency histograms within
``hist_close`` per point).

Small shapes: 4 servers, C = 8, a 16-lane client batch, 2 points, dynamic
sizing on so that ``active_size`` moves.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import kernels as jkn  # noqa: E402
from repro.core import controller as jctl  # noqa: E402
from test_torch_fleet import SEEDS, TOL, two_fleets, workload  # noqa: E402
from torch_parity import assert_trees_equal  # noqa: E402

from repro_torch.core import controller as tctl  # noqa: E402
from repro_torch.interop import to_numpy  # noqa: E402
from repro_torch.kvstore import fleet as tfl  # noqa: E402
from repro_torch.kvstore import simulator as tsim  # noqa: E402

RACK = dict(num_servers=4, cache_entries=8, client_batch=16, value_pad=16,
            subrounds=4, fetch_lanes=8, seed=5)
CTRL = dict(active_size=6, min_size=2, max_size=8, size_step=2,
            overflow_threshold=0.01, dynamic_sizing=True, k_report=8)
PERIODS, PERIOD_W, SWAP = 2, 4, 8


def test_serial_and_fleet_controller_paths_equal():
    """Two phases of 2 periods of 4 windows, ``hot_in_swap`` and
    ``refresh_workloads`` between them: each point equals the serial rack
    of its seed in every trace and period update, and after the run in
    switch state and ``active_size``."""
    cfg = tsim.RackConfig(**RACK, track_popularity=True)
    wl_f = workload()
    fleet = tfl.BatchedRackSimulator(cfg, wl_f, seeds=SEEDS, device="cpu")
    fleet.controllers = [tctl.CacheController(tctl.ControllerConfig(**CTRL))
                         for _ in SEEDS]
    fleet.preload()
    wls, sims = [], []
    for seed in SEEDS:
        wl = workload()
        sim = tsim.RackSimulator(dataclasses.replace(cfg, seed=seed), wl,
                                 device="cpu")
        sim.controller = tctl.CacheController(tctl.ControllerConfig(**CTRL))
        sim.preload(wl.hottest_keys(cfg.cache_entries))
        wls.append(wl)
        sims.append(sim)
    sizes = []
    for phase in range(2):
        if phase:
            wl_f.hot_in_swap(SWAP)
            fleet.refresh_workloads()
            for wl in wls:
                wl.hot_in_swap(SWAP)
        got = fleet.run_periods(PERIODS, PERIOD_W)
        for i, sim in enumerate(sims):
            want = sim.run_periods(PERIODS, PERIOD_W)
            for k, v in want.items():
                np.testing.assert_array_equal(got[k][i], v,
                                              err_msg=f"{phase} {i} {k}")
            for name, g, w in zip(sim._last_update._fields,
                                  fleet._last_update, sim._last_update):
                np.testing.assert_array_equal(g[i], w,
                                              err_msg=f"update {name}")
            assert fleet.controllers[i].active_size == \
                sim.controller.active_size
        sizes.append([c.active_size for c in fleet.controllers])
    for i, sim in enumerate(sims):
        assert_trees_equal(tsim.tree_take(fleet.carry.policy, i),
                           to_numpy(sim.carry.policy), f"point {i} policy")
        assert_trees_equal(tsim.tree_take(fleet.carry.servers, i),
                           to_numpy(sim.carry.servers), f"point {i} servers")
    assert fleet._wl_axes == (None, None, None)
    assert any(s != CTRL["active_size"] for ss in sizes for s in ss), sizes


def test_fleet_run_periods_matches_jax():
    """The port's fleet against the reference's batched ``run_periods``
    through the same two phases and swap, on the reference's draws, with
    dynamic sizing: traces, stacked carry, ``TracedUpdate`` ``[N,
    n_periods, ...]`` and each point's ``active_size``."""
    n_windows = 16 + 2 * PERIODS * PERIOD_W
    ref, port, wls_j, wls_t = two_fleets(dict(RACK, scheme="orbitcache"),
                                         n_windows, track=True)
    for sim, mod in ((ref, jctl), (port, tctl)):
        sim.controllers = [mod.CacheController(mod.ControllerConfig(**CTRL))
                           for _ in SEEDS]
    inserted = 0
    jkn.set_kernel_backend("ref")
    try:
        ref.preload()
        port.preload()
        for phase in range(2):
            if phase:
                for wl in wls_j + wls_t:
                    wl.hot_in_swap(SWAP)
                ref.refresh_workloads()
                port.refresh_workloads()
            m_ref = ref.run_periods(PERIODS, PERIOD_W)
            m_port = port.run_periods(PERIODS, PERIOD_W)
            label = f"phase {phase}"
            for k, v in m_ref.items():
                v = np.asarray(v)
                assert m_port[k].dtype == v.dtype, (label, k)
                np.testing.assert_array_equal(m_port[k], v,
                                              err_msg=f"{label}: {k}")
            assert_trees_equal(port.carry, ref.carry, label, tolerate=TOL)
            assert_trees_equal(port._last_update, ref._last_update,
                               label + " updates")
            assert [c.active_size for c in port.controllers] == \
                [c.active_size for c in ref.controllers]
            inserted += int(np.asarray(ref._last_update.n_insert).sum())
    finally:
        jkn.set_kernel_backend(None)
    assert port._wl_axes == ref._wl_axes
    assert inserted > 0
