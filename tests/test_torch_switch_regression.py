"""The port's fused path against its composed path, the counterpart of
``tests/test_switch_regression.py``.

The fused path runs each subround as one ``kernels.subround`` call (its
plain version here on the CPU, the hand-written kernel on the card); the
composed path (``tests/torch_composed.py``) builds the same pass from
``lookup``, ``request_table``, ``state_table`` and ``orbit``.  They must
agree bit for bit:

  * per step: ``switch_step`` against the composed seed step;
  * per window: ``window_step`` against the composed window, for all
    three schemes, every metric and carry leaf;
  * on the subround edge cases: zero recirculation budget, full request
    queues, multi-fragment lines, all-invalid ingress;
  * and the running counters saturate instead of wrapping.
"""
import numpy as np
import pytest
import torch

import torch_composed as tc
from repro_torch.core.switch import switch_step
from repro_torch.core.types import COUNTER_MAX, sat_add
from repro_torch.interop import to_numpy
from repro_torch.kvstore.simulator import RackConfig, RackSimulator
from repro_torch.kvstore.workload import Workload, WorkloadConfig
from torch_parity import assert_trees_equal, tree_leaves_with_path

I32 = torch.int32


def same(a, b, label):
    """Assert two port trees equal leaf for leaf; return the leaf count."""
    want = to_numpy(b)
    assert_trees_equal(a, want, label)
    return len(tree_leaves_with_path(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_switch_step_bit_identical_to_composed(seed):
    rng = np.random.default_rng(seed)
    sw, _, boot = tc.boot("cpu")
    steps = [(boot, 100)] + [(tc.traffic("cpu", rng), b)
                             for b in (100, 3, 0, 100, 7, 100)]
    tc.run_compare(sw, steps, f"seed {seed}", same)


@pytest.mark.parametrize("scheme", ["orbitcache", "netcache", "nocache"])
def test_window_step_bit_identical_to_composed(scheme):
    wl = Workload(WorkloadConfig(num_keys=5_000, offered_rps=1.5e6,
                                 write_ratio=0.1), device="cpu")
    cfg = RackConfig(scheme=scheme, cache_entries=32, num_servers=4,
                     client_batch=128, fetch_lanes=32, value_pad=64,
                     server_queue=32, subrounds=2)
    sim = RackSimulator(cfg, wl, device="cpu")
    if scheme == "orbitcache":
        sim.preload(wl.hottest_keys(32))
    elif scheme == "netcache":
        sim.preload(wl.hottest_keys(500))
    leaves, carry = tc.fused_and_composed(sim, 4, same)
    assert leaves > 100
    if scheme != "nocache":
        assert int(torch.sum(carry.clients.rx_switch)) > 0


def _edge(name):
    sw, steps, keys = tc.edge_cases("cpu")[name]
    return tc.run_compare(sw, steps, name, same)[0], keys


def test_fused_zero_recirc_budget():
    """Zero budget: queues fill, nothing serves, nothing pops."""
    sw_end, _ = _edge("zero_budget")
    assert int(torch.sum(sw_end.reqtab.qlen)) > 0


def test_fused_full_request_queues():
    """Full queues: same-key floods overflow while full, then a budgeted
    round drains the fronts."""
    sw_end, _ = _edge("full_queues")
    assert int(torch.max(sw_end.reqtab.qlen)) <= sw_end.reqtab.queue_size


def test_fused_multi_fragment_lines():
    """max_frags > 1: an entry serves only when every fragment is live,
    and a half-installed entry stays quiet."""
    sw_end, ks = _edge("multi_fragment")
    live = sw_end.orbit.live.reshape(sw_end.orbit.frags.shape[0], -1)
    complete = live.sum(dim=1) >= sw_end.orbit.frags
    kidx_of = {int(k): c for c, k in enumerate(sw_end.lookup.kidx.tolist())}
    assert not bool(complete[kidx_of[ks[2]]])
    assert bool(complete[kidx_of[ks[0]]])


def test_fused_all_invalid_ingress():
    """An all-invalid batch leaves every table untouched but still runs
    the serving round."""
    _edge("all_invalid")


def test_running_counters_saturate_instead_of_wrapping():
    top = COUNTER_MAX
    near = torch.tensor(top - 2, dtype=torch.int64)
    assert int(sat_add(near, torch.tensor(1, dtype=I32))) == top - 1
    assert int(sat_add(near, torch.tensor(100, dtype=I32))) == top
    assert int(sat_add(torch.tensor(top, dtype=torch.int64), 7)) == top

    sw, _, boot = tc.boot("cpu")
    sw, _ = switch_step(sw, boot, torch.tensor(100, dtype=I32), 4)
    ctr = sw.counters
    sw = sw._replace(counters=ctr._replace(
        hits=torch.full_like(ctr.hits, top - 1),
        cached_reqs=torch.full_like(ctr.cached_reqs, top - 1),
        popularity=torch.full_like(ctr.popularity, top - 1)))
    sw2, out = switch_step(sw, tc.read_batch("cpu", [0, 1, 0, 2]),
                           torch.tensor(0, dtype=I32), 4)
    assert int(out.stats.n_hit) > 0
    assert int(sw2.counters.hits) == top
    assert int(torch.max(sw2.counters.popularity)) == top
    assert bool(torch.all(sw2.counters.popularity >= sw.counters.popularity))
