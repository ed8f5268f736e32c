"""The write path's counts (``simulator.WRITE_PATH``) of the port alone:
where the scheme has them, what read-only traffic gives, and that they
stay out of what the benchmark compares.

The structures the benchmark compares (``WindowMetrics``, the traces, the
carry) must keep the frozen reference's (``simbench/reference/``) fields,
so that no counter reaches them.  The ``cuda``-marked case holds the
card's fleet against the CPU's on the Twitter cluster045 configuration at
the tiny size (``python3 -m pytest -q -m cuda
tests/test_torch_write_counts.py``) and skips without a card.  Against
the JAX reference: ``tests/test_torch_write_path.py``.

Small shapes: 4 servers, C = 16, a 64-lane client batch, 5,000 keys,
values 64 B / 1,024 B at 95 / 5 %, writes at 0.2.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.analysis.rules import leaves
from repro_torch.kvstore import client as tcl
from repro_torch.kvstore import fleet as tfl
from repro_torch.kvstore import simulator as tsim
from repro_torch.kvstore import workload as twl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RACK = dict(cache_entries=16, num_servers=4, client_batch=64, subrounds=4,
            fetch_lanes=32, netcache_table=256, netcache_value_limit=64,
            seed=3)
WORKLOAD = dict(num_keys=5000, offered_rps=0.5e6, write_ratio=0.2,
                value_sizes=((64, 0.95), (1024, 0.05)))
OFFERED = (0.3e6, 0.5e6, 0.7e6)     # the fleet's 3 points
SEEDS = (3, 4, 5)
PRELOAD = 16                        # the windows an OrbitCache preload runs
WINDOWS = 16                        # counted, in two chunks of 8
CHUNK = 8
NETCACHE_KEYS = 40
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def preload_keys(scheme, wl):
    return wl.hottest_keys(RACK["cache_entries"] if scheme == "orbitcache"
                           else NETCACHE_KEYS)


def port_counts(res):
    wp = res.write_path
    return np.stack([wp[k] for k in tsim.WRITE_PATH], axis=1)


@pytest.mark.parametrize("kind", ("rack", "fleet"))
@pytest.mark.parametrize("scheme", ("orbitcache", "netcache"))
def test_read_only_traffic_neither_invalidates_nor_validates(kind, scheme):
    """At ``write_ratio`` 0 no line is invalidated or re-validated; a read
    forwarded for an invalid line is counted in ``overflow`` too, where
    OrbitCache counts it."""
    for ratio in (0.0, 0.2):
        wl = twl.Workload(twl.WorkloadConfig(**dict(WORKLOAD,
                                                    write_ratio=ratio)),
                          device="cpu")
        cfg = tsim.RackConfig(**RACK, scheme=scheme)
        if kind == "rack":
            sim = tsim.RackSimulator(cfg, wl, device="cpu")
            sim.preload(preload_keys(scheme, wl))
            results = [sim.run(WINDOWS * 100e-6, chunk_windows=CHUNK)]
        else:
            sim = tfl.BatchedRackSimulator(cfg, wl, offered_rps=OFFERED,
                                           device="cpu")
            sim.preload([preload_keys(scheme, wl)] * len(OFFERED))
            results = sim.run(WINDOWS * 100e-6, chunk_windows=CHUNK)
        for res in results:
            wp = res.write_path
            assert set(wp) == set(tsim.WRITE_PATH)
            assert all(v.shape == (WINDOWS,) for v in wp.values())
            if ratio == 0.0:
                assert wp["invalidations"].sum() == 0
                assert wp["validations"].sum() == 0
            else:
                assert wp["invalidations"].sum() > 0
            if scheme == "orbitcache":
                assert wp["invalid_fwd"].sum() <= res.traces["overflow"].sum()
                assert (wp["invalid_fwd"] <= res.traces["overflow"]).all()


def test_nocache_has_no_counts():
    """NoCache caches nothing: its runs carry no counts, and a window
    asked for them refuses."""
    cfg = tsim.RackConfig(**RACK, scheme="nocache")
    wl = twl.Workload(twl.WorkloadConfig(**WORKLOAD), device="cpu")
    sim = tsim.RackSimulator(cfg, wl, device="cpu")
    assert sim.run(CHUNK * 100e-6, chunk_windows=CHUNK).write_path == {}
    with pytest.raises(ValueError, match="NoCache"):
        tsim.window_step(cfg, sim.server_cfg, sim.client_cfg, sim.key_size,
                         wl.arrays, sim.carry,
                         counts=torch.zeros(3, dtype=torch.int32))


def test_counts_stay_out_of_what_the_benchmark_compares():
    """The port's ``WindowMetrics`` fields, trace keys, carry leaves and
    run info are the frozen reference's (its info that of the JAX
    package), scheme by scheme."""
    from simbench.check import flatten
    from simbench.reference import rack as rrack
    from simbench.reference.kvstore import client as rcl
    from simbench.reference.kvstore import simulator as rsim
    from simbench.reference.kvstore import workload as rwl

    assert tsim.WindowMetrics._fields == rsim.WindowMetrics._fields
    assert tsim.SimCarry._fields == rsim.SimCarry._fields
    for scheme in ("orbitcache", "netcache", "nocache"):
        cfg = dict(RACK, scheme=scheme)
        wl_t = twl.Workload(twl.WorkloadConfig(**WORKLOAD), device="cpu")
        port = tsim.RackSimulator(tsim.RackConfig(**cfg), wl_t, device="cpu")
        res = port.run(CHUNK * 100e-6, chunk_windows=CHUNK)
        wl_r = rwl.Workload(rwl.WorkloadConfig(**WORKLOAD), device="cpu")
        ref = rrack.Rack(rsim.RackConfig(**cfg), wl_r,
                         WORKLOAD["offered_rps"], WORKLOAD["write_ratio"],
                         rcl.TorchDraws(RACK["seed"], CPU), CPU)
        traces = ref.windows(CHUNK)
        assert set(res.traces) == set(traces), scheme
        assert set(flatten(port.carry)) == set(flatten(ref.carry)), scheme
        assert set(res.info) == {"scheme", "active_size"}
        assert bool(res.write_path) == (scheme != "nocache")


def load_config(name):
    with open(os.path.join(ROOT, "simbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_twitter045_rack_is_the_paper_rack():
    """The cluster045 deployment runs on the paper's rack, field for
    field; only its workload and traffic differ."""
    paper = load_config("orbitcache-paper-rack")
    t045 = load_config("orbitcache-twitter045-rack")
    assert t045["rack"] == paper["rack"]
    assert t045["preload_keys"] == paper["preload_keys"]
    assert t045["workload"] == dict(paper["workload"],
                                    value_sizes=[[64, 0.95], [1024, 0.05]])
    assert t045["reduced"] == []


@pytest.mark.cuda
def test_twitter045_fleet_card_matches_cpu():
    """The cluster045 configuration at the benchmark's tiny size, a fleet
    of 3 points at 0.2 writes: the card's graphed chunks equal the CPU's
    on the same draws, counts and carry, leaf for leaf."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; CUDA graphs have no CPU mode")
    from simbench import tiny
    from simbench.spec import merge, rack_config, workload_config

    config = merge(load_config("orbitcache-twitter045-rack"),
                   tiny.BASE["config"])
    traffic = {"offered_rps": 0.0, "write_ratio": 0.2}
    cfg = tsim.RackConfig(**rack_config(config, traffic, 7))
    windows = 3 * CHUNK
    rng = np.random.default_rng(7)
    b = cfg.client_batch
    recorded = [(np.minimum(rng.poisson(o * cfg.window_us * 1e-6,
                                        PRELOAD + windows), b),
                 rng.random((PRELOAD + windows, b), np.float32),
                 rng.random((PRELOAD + windows, b), np.float32))
                for o in OFFERED]
    out = {}
    for dev in ("cuda", "cpu"):
        wl = twl.Workload(twl.WorkloadConfig(
            **workload_config(config, traffic, 7)), device=dev)
        fleet = tfl.BatchedRackSimulator(
            cfg, wl, offered_rps=OFFERED, seeds=SEEDS, device=dev,
            draws=[tcl.ReplayDraws(*d, dev) for d in recorded])
        assert fleet.chunk.graphs == (dev == "cuda")
        fleet.preload([wl.hottest_keys(config["preload_keys"])]
                      * len(OFFERED))
        res = fleet.run(windows * 100e-6, chunk_windows=CHUNK)
        out[dev] = ([port_counts(r) for r in res],
                    {k: t.to("cpu", copy=True) for k, t in leaves(
                        fleet.carry._replace(draws=()))})
    for i in range(len(OFFERED)):
        np.testing.assert_array_equal(out["cuda"][0][i], out["cpu"][0][i],
                                      err_msg=f"point {i}")
        assert (out["cpu"][0][i].sum(axis=0) > 0).all(), i
    assert out["cuda"][1].keys() == out["cpu"][1].keys()
    for path, t in out["cuda"][1].items():
        assert torch.equal(t, out["cpu"][1][path]), path
