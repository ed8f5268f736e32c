"""The port's batched fleet (``repro_torch.kvstore.fleet``) against serial
port racks and against the reference's ``BatchedRackSimulator``.

Point ``i`` of a fleet must be the serial rack with the same draw source,
leaf for leaf (the fleet is a batching transform, as
``tests/test_fleet.py`` holds the reference to), and the port's fleet must
be the reference's fleet on the same draws: the reference's ``jax.random``
draws of each point replayed (``ReplayDraws`` rows from
``test_torch_simulator.jax_draws``), its stacked carry handed across with
``interop.fleet_carry_from_numpy``.  Exact but for the latency
histograms' stated ``log2`` tolerance (``test_torch_simulator.hist_close``,
per point).

Small shapes: 4 servers, C = 16, a 32-lane client batch, 2 points.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import kernels as jkn  # noqa: E402
from repro.kvstore import fleet as jfl  # noqa: E402
from repro.kvstore import simulator as jsim  # noqa: E402
from repro.kvstore import workload as jwl  # noqa: E402
from test_torch_simulator import hist_close, jax_draws  # noqa: E402
from torch_parity import assert_trees_equal  # noqa: E402

from repro_torch import kernels as kn  # noqa: E402
from repro_torch.interop import fleet_carry_from_numpy, to_numpy  # noqa: E402
from repro_torch.kvstore import client as tcl  # noqa: E402
from repro_torch.kvstore import fleet as tfl  # noqa: E402
from repro_torch.kvstore import simulator as tsim  # noqa: E402
from repro_torch.kvstore import workload as twl  # noqa: E402

RACK = dict(num_servers=4, cache_entries=16, client_batch=32, value_pad=16,
            subrounds=4, fetch_lanes=8, netcache_table=64,
            netcache_value_limit=16, seed=5)
WORKLOAD = dict(num_keys=2000, offered_rps=0.3e6, write_ratio=0.1,
                value_sizes=((16, 0.5), (48, 0.3), (1024, 0.2)))
SCHEMES = ("orbitcache", "netcache", "nocache")
SEEDS = (5, 9)
NETCACHE_KEYS = 20
WINDOWS = 8
CPU = torch.device("cpu")


def per_point_hist(got, want, path):
    """``hist_close`` for each point's histogram of a stacked leaf."""
    for i in range(want.shape[0]):
        hist_close(got[i], want[i], f"{path}[{i}]")


TOL = {".hist_switch": per_point_hist, ".hist_server": per_point_hist}


def workload(**kw):
    return twl.Workload(twl.WorkloadConfig(**dict(WORKLOAD, **kw)),
                        device="cpu")


def preload_keys(cfg, wls):
    k = cfg.cache_entries if cfg.scheme == "orbitcache" else NETCACHE_KEYS
    return [w.hottest_keys(k) for w in wls]


def serial_rack(cfg, wl, seed, keys):
    sim = tsim.RackSimulator(dataclasses.replace(cfg, seed=seed), wl,
                             device="cpu")
    if cfg.scheme != "nocache":
        sim.preload(np.asarray(keys))
    return sim


def assert_point_equals(fleet_traces, fleet_carry, i, traces, carry, label):
    for k, v in traces.items():
        assert fleet_traces[k].dtype == v.dtype, (label, k)
        np.testing.assert_array_equal(fleet_traces[k][i], v,
                                      err_msg=f"{label}: trace {k}")
    got = tsim.tree_take(fleet_carry._replace(draws=()), i)
    assert_trees_equal(got, to_numpy(carry._replace(draws=())), label)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_fleet_points_match_serial(scheme):
    """Each point of a 2-point fleet (``TorchDraws`` of its seed) equals the
    serial port rack of that seed: every trace and carry leaf, after the
    preload and 8 windows."""
    cfg = tsim.RackConfig(**RACK, scheme=scheme)
    wl = workload()
    keys = preload_keys(cfg, [wl, wl])
    fleet = tfl.BatchedRackSimulator(cfg, wl, seeds=SEEDS, device="cpu")
    fleet.preload(keys if scheme == "netcache" else None)
    got = fleet.run_windows(WINDOWS)
    assert got["tx"].shape == (2, WINDOWS)
    for i, seed in enumerate(SEEDS):
        sim = serial_rack(cfg, wl, seed, keys[i])
        want = sim.run_windows(WINDOWS)
        assert_point_equals(got, fleet.carry, i, want, sim.carry,
                            f"{scheme} point {i}")
    assert got["tx"].sum() > 0 and got["fwd"].sum() > 0


def two_fleets(rack, n_windows, wl_kw=({}, {}), offered=None,
               track=False):
    """The reference's fleet and the port's, from one stacked carry and
    the reference's draws of each point: ``(ref, port, wls_j, wls_t)``."""
    jcfg = jsim.RackConfig(**rack, track_popularity=track)
    wls_j = [jwl.Workload(jwl.WorkloadConfig(**dict(WORKLOAD, **kw)))
             for kw in wl_kw]
    wls_t = [workload(**kw) for kw in wl_kw]
    ref = jfl.BatchedRackSimulator(jcfg, wls_j, offered_rps=offered,
                                   seeds=SEEDS)
    b = rack["client_batch"]
    draws = [tcl.ReplayDraws(*jax_draws(seed, np.asarray(
        ref.carry.offered[i]), b, n_windows), CPU)
             for i, seed in enumerate(SEEDS)]
    port = tfl.BatchedRackSimulator(
        tsim.RackConfig(**rack, track_popularity=track), wls_t,
        offered_rps=offered, seeds=SEEDS, device="cpu", draws=draws)
    port.carry = fleet_carry_from_numpy(jax.tree.map(np.asarray, ref.carry),
                                        draws, CPU)
    return ref, port, wls_j, wls_t


def assert_fleets_equal(m_port, m_ref, port, ref, label):
    assert set(m_port) == set(m_ref), label
    for k, v in m_ref.items():
        v = np.asarray(v)
        assert m_port[k].dtype == v.dtype, (label, k)
        np.testing.assert_array_equal(m_port[k], v, err_msg=f"{label}: {k}")
    assert_trees_equal(port.carry, ref.carry, label, tolerate=TOL)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_fleet_matches_jax(scheme):
    """The port's fleet against the reference's ``BatchedRackSimulator``
    (a skew sweep: the CDF stacked): the preload, then two chunks of 6
    windows, per-point ``set_write_ratio`` and ``reset_stats`` between
    them.  Every trace ``[N, n]`` and stacked carry leaf is equal."""
    rack = dict(RACK, scheme=scheme)
    n_pre = 16 if scheme == "orbitcache" else 0
    ref, port, wls_j, _ = two_fleets(rack, n_pre + 12,
                                     wl_kw=({}, dict(zipf_alpha=0.9)))
    assert port._wl_axes == ref._wl_axes
    jkn.set_kernel_backend("ref")
    try:
        keys = ([w.hottest_keys(NETCACHE_KEYS) for w in wls_j]
                if scheme == "netcache" else None)
        ref.preload(keys)
        port.preload(keys)
        assert_trees_equal(port.carry, ref.carry, f"{scheme} preload",
                           tolerate=TOL)
        for i in range(2):
            if i:
                # the replayed draws keep the first Poisson mean, so the
                # load stays (set_offered has its own test below)
                for sim in (ref, port):
                    sim.set_write_ratio([0.5, 0.2])
                    sim.reset_stats()
            m_ref = ref.run_windows(6)
            m_port = port.run_windows(6)
            assert_fleets_equal(m_port, m_ref, port, ref,
                                f"{scheme} chunk {i}")
    finally:
        jkn.set_kernel_backend(None)
    assert m_port["tx"].shape == (2, 6) and m_port["tx"].sum() > 0


def test_set_offered_is_the_references_float32_product():
    """``set_offered`` gives the reference fleet's float32 product, per
    point (the serial rack rounds a double product instead)."""
    jcfg = jsim.RackConfig(**RACK)
    ref = jfl.BatchedRackSimulator(jcfg, jwl.Workload(jwl.WorkloadConfig(
        **WORKLOAD)), n_points=3)
    port = tfl.BatchedRackSimulator(tsim.RackConfig(**RACK), workload(),
                                    n_points=3, device="cpu")
    loads = [0.123e6, 1.7e6, 3.3e6]
    ref.set_offered(loads)
    port.set_offered(loads)
    np.testing.assert_array_equal(to_numpy(port.carry.offered),
                                  np.asarray(ref.carry.offered))
    # seeds default to cfg.seed + point, as the reference's
    assert [d.gen.initial_seed() for d in port.carry.draws.sources] == \
        [RACK["seed"] + i for i in range(3)]


@pytest.mark.parametrize("scheme", ["orbitcache", "netcache"])
def test_fleet_preload_tables_match_serial(scheme):
    """Per-point preload under a stacked CDF (perm and vlen shared) builds
    each point's serial tables, checked on the policy right after the
    preload."""
    cfg = tsim.RackConfig(**RACK, scheme=scheme)
    wls = [workload(), workload(zipf_alpha=0.9)]
    wls[1].hot_in_swap(4)      # the points' hot sets differ
    keys = preload_keys(cfg, wls)
    fleet = tfl.BatchedRackSimulator(cfg, wls, device="cpu")
    assert fleet._wl_axes == (0, 0, None)
    fleet.preload(keys)
    for i, w in enumerate(wls):
        sim = serial_rack(cfg, w, cfg.seed + i, keys[i])
        assert_trees_equal(tsim.tree_take(fleet.carry.policy, i),
                           to_numpy(sim.carry.policy),
                           f"{scheme} point {i} policy")


def test_fleet_shares_unchanged_workload_leaves():
    """A leaf is stacked only where the points differ."""
    wl, wl2 = workload(), workload(zipf_alpha=0.9)
    cfg = tsim.RackConfig(**RACK)
    same = tfl.BatchedRackSimulator(cfg, wl, n_points=4, device="cpu")
    arrs, axes = same._wl_and_axes()
    assert axes == (None, None, None) and arrs.cdf is wl.cdf
    skew = tfl.BatchedRackSimulator(cfg, [wl, wl2], device="cpu")
    arrs, axes = skew._wl_and_axes()
    assert axes.cdf == 0 and axes.perm is None and axes.vlen is None
    assert tuple(arrs.cdf.shape) == (2, WORKLOAD["num_keys"])
    wl3 = workload()
    wl3.hot_in_swap(8)
    churn = tfl.BatchedRackSimulator(cfg, [wl, wl3], device="cpu")
    assert churn._wl_axes == (None, 0, None)


def test_fleet_offered_sweep_orders_tx():
    """A load sweep in one fleet: tx follows each point's offered load."""
    loads = (0.05e6, 0.1e6, 0.2e6)      # under the 32-lane batch's cap
    fleet = tfl.BatchedRackSimulator(tsim.RackConfig(**RACK), workload(),
                                     offered_rps=loads, device="cpu")
    fleet.preload()
    fleet.reset_stats()
    res = fleet.run(0.004, chunk_windows=20)
    assert len(res) == 3 and [r.info["point"] for r in res] == [0, 1, 2]
    tx = [r.offered_rps(burn_frac=0.0) for r in res]
    assert tx[0] < tx[1] < tx[2]
    for got, load in zip(tx, loads):
        assert abs(got - load) / load < 0.2


def test_fleet_rejects_mismatched_points():
    cfg = tsim.RackConfig(**RACK)
    wl = workload()
    with pytest.raises(ValueError, match="num_keys"):
        tfl.BatchedRackSimulator(cfg, [wl, workload(num_keys=500)],
                                 device="cpu")
    with pytest.raises(ValueError, match="key_size"):
        tfl.BatchedRackSimulator(cfg, [wl, workload(key_size=8)],
                                 device="cpu")
    with pytest.raises(ValueError, match="sweep points"):
        tfl.BatchedRackSimulator(cfg, [wl, wl, wl], offered_rps=(1e6, 2e6),
                                 device="cpu")
    with pytest.raises(ValueError, match="sweep points"):
        tfl.BatchedRackSimulator(cfg, wl, seeds=[1, 2, 3], n_points=2,
                                 write_ratios=(0.1, 0.2), device="cpu")
    draw = tcl.TorchDraws(0, CPU)
    with pytest.raises(ValueError, match="own draw source"):
        tfl.BatchedRackSimulator(cfg, wl, draws=[draw, draw], device="cpu")


OPS = {"subround": "_subround_op", "cms": "_cms_op",
       "hot_gather": "_hot_gather_op"}


@pytest.mark.parametrize("n_points", [1, 3])
def test_one_batched_op_call_per_call_site(n_points, monkeypatch):
    """A fleet window calls the batched subround op once per subround and
    the count-min op once, for all points; a period boundary the
    hot_gather op three times.  Each is one batched call (one launch on
    the card), never one per point; a serial rack calls none of them."""
    calls = dict.fromkeys(OPS, 0)
    for name, attr in OPS.items():
        def counted(*a, _real=getattr(kn, attr), _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(kn, attr, counted)

    def count(fn):
        calls.update(dict.fromkeys(OPS, 0))
        fn()
        return dict(calls)

    cfg = tsim.RackConfig(**RACK, track_popularity=True)
    fleet = tfl.BatchedRackSimulator(cfg, workload(), n_points=n_points,
                                     device="cpu")
    fleet.preload()
    assert count(lambda: fleet.run_windows(2)) == dict(
        subround=2 * cfg.subrounds, cms=2, hot_gather=0)
    assert count(lambda: fleet.run_periods(1, 2)) == dict(
        subround=2 * cfg.subrounds, cms=2, hot_gather=3)
    sim = serial_rack(cfg, workload(), 0, workload().hottest_keys(16))
    assert count(lambda: sim.run_periods(1, 2)) == dict.fromkeys(OPS, 0)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_no_vmap_fallback(scheme):
    """No op of a fleet window or period boundary falls back to vmap's
    per-point loop: with the fallback warning on and made an error, the
    window and the period run."""
    cfg = tsim.RackConfig(**RACK, scheme=scheme,
                          track_popularity=scheme == "orbitcache")
    fleet = tfl.BatchedRackSimulator(cfg, workload(), n_points=2,
                                     device="cpu")
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            fleet.preload([workload().hottest_keys(NETCACHE_KEYS)] * 2
                          if scheme == "netcache" else None)
            fleet.run_windows(2)
            if scheme == "orbitcache":
                fleet.run_periods(1, 2)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def test_fleet_runs_on_the_card_by_default():
    """``device=None`` is the CUDA card: without one the fleet names the
    problem rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfl.BatchedRackSimulator(tsim.RackConfig(**RACK), workload(),
                                 n_points=2)
