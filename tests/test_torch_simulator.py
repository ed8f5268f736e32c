"""The port's rack simulator against the JAX reference.

Both simulators start from one carry (handed across by
``repro_torch.interop``) and the port replays the reference's own
``jax.random`` draws, so every ``SimCarry`` leaf (except the PRNG key) and
every ``WindowMetrics`` field must be equal, exactly, after the preload and
after 16 more windows.

The one stated tolerance is the latency histograms: ``torch.log2`` and
``jnp.log2`` differ in the last bit for some float32 inputs, which can move
a latency that sits on a quarter-octave bucket edge into the neighbouring
bucket.  Totals must be equal; cumulative sums may differ by at most
max(2, 0.1 % of the samples).  The bucket feeds only the histograms.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import kernels as jkn  # noqa: E402
from repro.kvstore import simulator as jsim  # noqa: E402
from repro.kvstore import workload as jwl  # noqa: E402
from torch_parity import assert_trees_equal  # noqa: E402

from repro_torch.core import sketch as tsk  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    carry_from_numpy, to_numpy, workload_from_numpy)
from repro_torch.kvstore import client as tcl  # noqa: E402
from repro_torch.kvstore import server as tsrv  # noqa: E402
from repro_torch.kvstore import simulator as tsim  # noqa: E402
from repro_torch.kvstore import workload as twl  # noqa: E402

RACK = dict(cache_entries=16, num_servers=4, value_pad=64, client_batch=64,
            subrounds=4, fetch_lanes=32, seed=3)
WORKLOAD = dict(num_keys=5000, offered_rps=0.5e6, write_ratio=0.1)


def jax_draws(seed, offered, b, n_windows):
    """The reference's per-window draws (simulator.py:321,
    client.py:131-144): split the carry key, split again in three, then
    Poisson count, key uniforms, write-coin uniforms."""
    rng = jax.random.PRNGKey(seed)
    ns, us, ws = [], [], []
    for _ in range(n_windows):
        rng, r_gen = jax.random.split(rng)
        r1, r2, r3 = jax.random.split(r_gen, 3)
        ns.append(np.asarray(jax.random.poisson(r1, offered)))
        us.append(np.asarray(jax.random.uniform(r2, (b,), jnp.float32)))
        ws.append(np.asarray(jax.random.uniform(r3, (b,), jnp.float32)))
    return np.stack(ns), np.stack(us), np.stack(ws)


def hist_close(got, want, path):
    """Histogram tolerance (see the module docstring)."""
    got, want = got.astype(np.int64), want.astype(np.int64)
    total = int(want.sum())
    assert int(got.sum()) == total, f"{path}: totals differ"
    gap = np.abs(np.cumsum(got) - np.cumsum(want))
    moved = int(np.abs(got - want).sum()) // 2
    print(f"{path}: {moved} of {total} samples in a neighbouring bucket")
    assert gap.max() <= max(2, total // 1000), f"{path}: cumsum gap {gap}"


TOL = {".hist_switch": hist_close, ".hist_server": hist_close}


def test_rack_simulator_matches_jax():
    rcfg = jsim.RackConfig(**RACK)
    wl_j = jwl.Workload(jwl.WorkloadConfig(**WORKLOAD))
    wl_t = twl.Workload(twl.WorkloadConfig(**WORKLOAD), device="cpu")
    cpu = torch.device("cpu")
    carried = workload_from_numpy(jax.tree.map(np.asarray, wl_j.arrays), cpu)
    for name in ("cdf", "perm", "vlen"):
        assert torch.equal(getattr(wl_t, name), getattr(carried, name)), name

    jkn.set_kernel_backend("ref")
    try:
        ref = jsim.RackSimulator(rcfg, wl_j)
        draws = tcl.ReplayDraws(*jax_draws(rcfg.seed, ref.carry.offered,
                                           rcfg.client_batch, 32), cpu)
        port = tsim.RackSimulator(tsim.RackConfig(**RACK), wl_t,
                                  device="cpu", draws=draws)
        port.carry = carry_from_numpy(jax.tree.map(np.asarray, ref.carry),
                                      draws, cpu)
        keys = wl_j.hottest_keys(16)
        ref.preload(keys)
        port.preload(keys)
        assert_trees_equal(port.carry, ref.carry, "after preload",
                           tolerate=TOL)
        m_ref = ref.run_windows(16)
        m_port = port.run_windows(16)
    finally:
        jkn.set_kernel_backend(None)
    for k, v in m_ref.items():
        assert m_port[k].dtype == v.dtype, k
        np.testing.assert_array_equal(m_port[k], v, err_msg=f"metric {k}")
    assert_trees_equal(port.carry, ref.carry, "after 16 windows",
                       tolerate=TOL)
    # the run must exercise the switch: hits, serves, installs, writes
    assert m_ref["rx_switch"].sum() > 0 and m_ref["installs"].sum() > 0
    assert m_ref["hits"].sum() > 0 and m_ref["fwd"].sum() > 0


def test_periodic_rack_simulator_matches_jax():
    """The control-plane path: server tracking on, ``run`` with a period
    of 8 windows for 3 periods, then ``hot_in_swap(16)`` and 2 more
    periods, from one carry and the reference's draws.  Every carry leaf
    (the trackers included), every metric, the active size and every
    period's ``TracedUpdate`` must be equal."""
    rack = dict(RACK, track_popularity=True)
    rcfg = jsim.RackConfig(**rack)
    wl_j = jwl.Workload(jwl.WorkloadConfig(**WORKLOAD))
    wl_t = twl.Workload(twl.WorkloadConfig(**WORKLOAD), device="cpu")
    cpu = torch.device("cpu")
    period_s = 8 * rcfg.window_us * 1e-6
    jkn.set_kernel_backend("ref")
    try:
        ref = jsim.RackSimulator(rcfg, wl_j)
        draws = tcl.ReplayDraws(*jax_draws(rcfg.seed, ref.carry.offered,
                                           rcfg.client_batch, 56), cpu)
        port = tsim.RackSimulator(tsim.RackConfig(**rack), wl_t,
                                  device="cpu", draws=draws)
        port.carry = carry_from_numpy(jax.tree.map(np.asarray, ref.carry),
                                      draws, cpu)
        keys = wl_j.hottest_keys(16)
        ref.preload(keys)
        port.preload(keys)
        updates = {"ref": [], "port": []}
        record = lambda name: (lambda sim, w: updates[name].append(
            sim._last_update))
        results = []
        for n_periods, churn in ((3, False), (2, True)):
            if churn:
                wl_j.hot_in_swap(16)
                wl_t.hot_in_swap(16)
            results.append((
                ref.run(n_periods * period_s, controller_period_s=period_s,
                        on_period=record("ref")),
                port.run(n_periods * period_s, controller_period_s=period_s,
                         on_period=record("port"))))
            assert_trees_equal(port.carry, ref.carry,
                               f"after {len(updates['ref'])} periods",
                               tolerate=TOL)
            assert port.controller.active_size == ref.controller.active_size
    finally:
        jkn.set_kernel_backend(None)
    assert torch.equal(wl_t.perm, torch.from_numpy(np.array(wl_j.perm)))
    for r_ref, r_port in results:
        assert len(r_ref.traces["tx"]) in (24, 16)
        for k, v in r_ref.traces.items():
            assert r_port.traces[k].dtype == v.dtype, k
            np.testing.assert_array_equal(r_port.traces[k], v,
                                          err_msg=f"metric {k}")
        assert r_port.info == r_ref.info
    assert len(updates["port"]) == len(updates["ref"]) == 5
    for i, (u_port, u_ref) in enumerate(zip(updates["port"],
                                            updates["ref"])):
        assert_trees_equal(u_port, u_ref, f"period {i} update")
    # the controller must have acted: after the churn the new hot keys are
    # uncached, so only the servers' reports can bring them in
    n_ins = [int(u.n_insert.sum()) for u in updates["ref"]]
    assert sum(n_ins[3:]) > 0, n_ins


def test_unported_paths_raise():
    """Every scheme of the reference now runs, and an unknown one raises.
    NetCache and NoCache have no controller, so a periodic run takes plain
    window chunks on the period cadence; server tracking and the periodic
    controller run."""
    wl_t = twl.Workload(twl.WorkloadConfig(num_keys=100), device="cpu")
    with pytest.raises(ValueError, match="unknown scheme"):
        tsim.RackSimulator(tsim.RackConfig(scheme="lru"), wl_t, device="cpu")
    small = dict(num_servers=4, cache_entries=8, client_batch=16,
                 value_pad=16, fetch_lanes=8)
    for scheme in ("netcache", "nocache"):
        sim = tsim.RackSimulator(
            tsim.RackConfig(scheme=scheme, netcache_table=64,
                            netcache_value_limit=16, **small),
            wl_t, device="cpu")
        sim.preload(wl_t.hottest_keys(8))
        seen = []
        res = sim.run(0.0012, controller_period_s=0.0004,
                      on_period=lambda s, w: seen.append(w))
        assert seen == [4, 8, 12] and len(res.traces["tx"]) == 12
        assert res.info == dict(scheme=scheme, active_size=8)
    sim = tsim.RackSimulator(tsim.RackConfig(track_popularity=True, **small),
                             wl_t, device="cpu")
    sim.preload(wl_t.hottest_keys(8))
    seen = []
    res = sim.run(0.0012, controller_period_s=0.0004,
                  on_period=lambda s, w: seen.append(w))
    assert seen == [4, 8, 12] and len(res.traces["tx"]) == 12
    assert sim._last_update.n_insert.shape == (1,)
    assert int(sim.carry.servers.tracker.cms.counts.sum()) == 0  # reported
    sim = tsim.RackSimulator(tsim.RackConfig(**small), wl_t, device="cpu")
    res = sim.run(0.0012, controller_period_s=0.0004)
    assert len(res.traces["tx"]) == 12 and res.info["active_size"] == 8


SCHEME_WORKLOAD = dict(WORKLOAD, value_sizes=((16, 0.5), (48, 0.3),
                                             (1024, 0.2)))


@pytest.mark.parametrize("scheme", ["netcache", "nocache"])
def test_scheme_rack_simulator_matches_jax(scheme):
    """NetCache (a 64-slot table, a 32-byte value limit, so that probes
    collide, the cut runs and large values are refused) and NoCache, with
    writes on: after the preload and after 16 windows every carry leaf and
    every metric equals the reference.  Every switch-served NetCache lane
    has one latency, so ``hist_switch`` is exact; only ``hist_server``
    keeps the log2 tolerance."""
    rack = dict(RACK, scheme=scheme, netcache_table=64,
                netcache_value_limit=32)
    rcfg = jsim.RackConfig(**rack)
    wl_j = jwl.Workload(jwl.WorkloadConfig(**SCHEME_WORKLOAD))
    wl_t = twl.Workload(twl.WorkloadConfig(**SCHEME_WORKLOAD), device="cpu")
    cpu = torch.device("cpu")
    tol = {".hist_server": hist_close}
    jkn.set_kernel_backend("ref")
    try:
        ref = jsim.RackSimulator(rcfg, wl_j)
        draws = tcl.ReplayDraws(*jax_draws(rcfg.seed, ref.carry.offered,
                                           rcfg.client_batch, 16), cpu)
        port = tsim.RackSimulator(tsim.RackConfig(**rack), wl_t,
                                  device="cpu", draws=draws)
        port.carry = carry_from_numpy(jax.tree.map(np.asarray, ref.carry),
                                      draws, cpu)
        keys = wl_j.hottest_keys(40)
        ref.preload(keys)
        port.preload(keys)
        assert getattr(port, "_installed", None) == getattr(
            ref, "_installed", None)
        assert_trees_equal(port.carry, ref.carry, "after preload",
                           tolerate=tol)
        m_ref = ref.run_windows(16)
        m_port = port.run_windows(16)
    finally:
        jkn.set_kernel_backend(None)
    for k, v in m_ref.items():
        assert m_port[k].dtype == v.dtype, k
        np.testing.assert_array_equal(m_port[k], v, err_msg=f"metric {k}")
    assert_trees_equal(port.carry, ref.carry, "after 16 windows",
                       tolerate=tol)
    assert m_ref["fwd"].sum() > 0 and m_ref["rx_server"].sum() > 0
    if scheme == "netcache":
        assert 0 < port._installed < 40
        assert m_ref["hits"].sum() > 0
        assert int(port.carry.policy.version.sum()) > 0     # writes landed
    else:
        assert port.carry.policy == () and m_ref["rx_switch"].sum() == 0


def test_netcache_switch_latency_bucket_matches_jax():
    """The one latency of a switch-served NetCache lane (1 µs of switch
    pipeline plus the base round trip) falls in the reference's bucket."""
    lat = np.float32(1.0) + np.float32(tcl.ClientConfig().base_rtt_us)
    want = int(jsim.cl.lat_bucket(jnp.full((4,), 1.0, jnp.float32)
                                  + jsim.cl.ClientConfig().base_rtt_us)[0])
    assert int(tcl.lat_bucket(torch.tensor([lat]))[0]) == want


def test_device_control_plane_matches_host_oracle():
    """One period boundary two ways on one carry: the device form
    (``controller_window_apply``, as ``run_periods`` does it) and the host
    oracle (``_control_plane_update``: ``server_reports`` and
    ``CacheController.update``) give the same switch, servers and fetch
    batch."""
    wl_t = twl.Workload(twl.WorkloadConfig(num_keys=2000, offered_rps=1e6),
                        device="cpu")
    cfg = tsim.RackConfig(num_servers=4, cache_entries=16, client_batch=64,
                          value_pad=16, fetch_lanes=16, track_popularity=True)
    sim = tsim.RackSimulator(cfg, wl_t, device="cpu")
    sim.preload(wl_t.hottest_keys(8))
    sim.run_windows(12)
    wl_t.hot_in_swap(16)
    sim.run_windows(12)
    act = torch.tensor(sim.controller.active_size, dtype=torch.int32)
    dev_carry, _, upd, _ = tsim.controller_window_apply(
        cfg, sim.controller.cfg, wl_t.arrays, sim.carry, act)
    sim._control_plane_update()
    assert int(upd.n_insert) > 0
    assert [(int(k), int(c)) for k, c in zip(
        upd.fetch_kidx[:int(upd.n_insert)],
        upd.fetch_cidx[:int(upd.n_insert)])] == sim._last_update.fetches
    for name in ("policy", "servers", "fetch"):
        assert_trees_equal(getattr(dev_carry, name),
                           to_numpy(getattr(sim.carry, name)), name)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        twl.Workload(twl.WorkloadConfig(num_keys=100))


@pytest.mark.parametrize("build", [
    lambda: ttypes.init_switch_state(8),
    lambda: ttypes.empty_batch(8, 16),
    lambda: tsrv.init_servers(tsrv.ServerConfig(num_servers=2), 100),
    lambda: tcl.init_clients(tcl.ClientConfig(batch=8, value_pad=8)),
    lambda: tsk.init_tracker(64, 4),
], ids=["switch_state", "empty_batch", "servers", "clients", "tracker"])
def test_state_builders_default_to_cuda(build):
    """Every state builder resolves ``device=None`` to the card, as the
    entry points do: without one it names the problem, not the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()


def test_torch_draws_statistics():
    """TorchDraws through client.generate, 2,000 windows: the Poisson mean,
    the write share and the rank-1 share of the Zipf draw each within 4
    standard errors."""
    wl = twl.Workload(twl.WorkloadConfig(num_keys=1000), device="cpu")
    ccfg = tcl.ClientConfig(batch=64, subrounds=4, value_pad=8)
    draws = tcl.TorchDraws(11, "cpu")
    st = tcl.init_clients(ccfg, "cpu")
    lam, wr, n_win = 20.0, 0.25, 2000
    offered = torch.tensor(lam, dtype=torch.float32)
    ratio = torch.tensor(wr, dtype=torch.float32)
    now = torch.tensor(0.0, dtype=torch.float32)
    n_req = n_write = n_top = 0
    for _ in range(n_win):
        st, b = tcl.generate(st, ccfg, draws, wl.cdf, wl.perm, wl.vlen,
                             offered, ratio, 4, now)
        req = b.valid & (b.op <= 1)
        n_req += int(req.sum())
        n_write += int((req & (b.op == 1)).sum())
        n_top += int((req & (b.kidx == 0)).sum())
    assert abs(n_req / n_win - lam) < 4 * np.sqrt(lam / n_win)
    assert abs(n_write / n_req - wr) < 4 * np.sqrt(wr * (1 - wr) / n_req)
    p0 = float(wl.cdf[0])
    assert abs(n_top / n_req - p0) < 4 * np.sqrt(p0 * (1 - p0) / n_req)
    assert int(st.tx) == n_req
