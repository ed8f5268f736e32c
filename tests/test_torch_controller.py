"""The port's device controller step against the JAX ``controller_step``
and against the port's host ``CacheController``, exactly.

Randomized chained periods (the model is ``tests/test_controller.py``):
each period's output state feeds the next with fresh traffic counters,
with dynamic sizing off and on; the merge runs through the port's
``kernels.hot_gather``.  Every switch-state leaf, the active size and
every ``TracedUpdate`` leaf must equal the reference, and the F-REQ and
eviction lanes must list the host oracle's fetches and evictions.  One
case runs the spine controller's ``install_live`` mode.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import kernels as jkn  # noqa: E402
from repro.core import controller as jctl  # noqa: E402
from repro.core.types import COUNTER_DTYPE  # noqa: E402
from test_controller import random_reports, random_state  # noqa: E402
from torch_parity import assert_trees_equal  # noqa: E402

from repro_torch.core import controller as tctl  # noqa: E402
from repro_torch.interop import from_numpy, to_numpy  # noqa: E402

CPU = torch.device("cpu")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# the reference step compiled on its ref backend (the interpret case runs
# it eagerly, so no compilation of one backend serves the other)
_jit_step = jax.jit(jctl.controller_step,
                    static_argnames=("cfg", "install_live"))


def configs(**kw):
    return jctl.ControllerConfig(**kw), tctl.ControllerConfig(**kw)


def both_steps(sw, reports, jcfg, tcfg, active, backend="ref",
               install_live=False, vlen=None):
    """The reference and the port on identical inputs:
    ``((sw', active', upd) reference as numpy, the same from the port)``."""
    rk = np.concatenate([k for k, _ in reports])
    re_ = np.concatenate([e for _, e in reports])
    ovf, cr = sw.counters.overflow, sw.counters.cached_reqs
    kw = dict(install_live=install_live)
    step = _jit_step if backend == "ref" else jctl.controller_step
    jkn.set_kernel_backend(backend)
    try:
        want = step(
            sw, jnp.asarray(rk), jnp.asarray(re_), ovf, cr,
            jnp.int32(active), jcfg,
            report_vlen=None if vlen is None else jnp.asarray(vlen), **kw)
    finally:
        jkn.set_kernel_backend(None)
    sw_t = from_numpy(np_tree(sw), CPU)
    got = tctl.controller_step(
        sw_t, torch.from_numpy(rk), torch.from_numpy(re_),
        sw_t.counters.overflow, sw_t.counters.cached_reqs,
        torch.tensor(active, dtype=torch.int32), tcfg,
        report_vlen=None if vlen is None else torch.from_numpy(vlen), **kw)
    return np_tree(want), got


def check_period(sw, reports, jcfg, tcfg, host, label, backend="ref"):
    """One period through the reference, the port and the port's host
    oracle; returns the reference's next state."""
    active = host.active_size
    want, got = both_steps(sw, reports, jcfg, tcfg, active, backend)
    (w_sw, w_act, w_upd), (g_sw, g_act, g_upd) = want, got
    assert_trees_equal(g_sw, w_sw, f"{label} state")
    assert g_act.dtype == torch.int32 and int(g_act) == int(w_act), label
    assert_trees_equal(g_upd, w_upd, f"{label} update")

    sw_t = from_numpy(np_tree(sw), CPU)
    h_sw, info = host.update(sw_t, [(k, e) for k, e in reports],
                             int(sw.counters.overflow),
                             int(sw.counters.cached_reqs))
    assert int(g_act) == host.active_size, label
    assert_trees_equal(g_sw, to_numpy(h_sw), f"{label} vs host")
    n_f = int(g_upd.n_insert)
    assert list(zip(g_upd.fetch_kidx[:n_f].tolist(),
                    g_upd.fetch_cidx[:n_f].tolist())) == info.fetches, label
    assert not bool(g_upd.fetch_valid[n_f:].any()), label
    n_e = int(g_upd.n_evict)
    assert g_upd.evicted_kidx[:n_e].tolist() == list(info.evicted), label
    return w_sw


def next_counters(rng, sw, cap):
    """Fresh traffic counters on the evolving state (the next period)."""
    return sw._replace(counters=sw.counters._replace(
        popularity=jnp.asarray(rng.integers(0, 500, cap).astype(np.uint32)
                               * np.asarray(sw.lookup.occupied)),
        overflow=jnp.asarray(rng.integers(0, 40), COUNTER_DTYPE),
        cached_reqs=jnp.asarray(rng.integers(0, 3000), COUNTER_DTYPE)))


@pytest.mark.parametrize("trial", range(6))
@pytest.mark.parametrize("dynamic", [False, True])
def test_controller_step_matches_reference_over_chained_periods(dynamic,
                                                                 trial):
    rng = np.random.default_rng(1000 * dynamic + trial)
    cap = int(rng.integers(4, 24))
    jcfg, tcfg = configs(
        active_size=int(rng.integers(2, cap + 4)), min_size=2,
        max_size=cap + 4, size_step=3, dynamic_sizing=dynamic,
        overflow_threshold=float(rng.choice([0.01, 0.05])))
    host = tctl.CacheController(tcfg)
    sw = random_state(rng, cap=cap)
    for period in range(3):
        sw = check_period(sw, random_reports(rng), jcfg, tcfg, host,
                          f"dyn={dynamic} trial {trial} period {period}")
        sw = next_counters(rng, jax.tree.map(jnp.asarray, sw), cap)


def test_controller_step_matches_interpret_backend():
    """The reference merging through the Pallas hot_gather kernel (under
    the interpreter) gives the same period as the port."""
    rng = np.random.default_rng(77)
    jcfg, tcfg = configs(active_size=12, min_size=2, max_size=20,
                         size_step=2, dynamic_sizing=True)
    host = tctl.CacheController(tcfg)
    sw = random_state(rng, cap=16)
    for period in range(2):
        sw = check_period(sw, random_reports(rng, n_srv=4), jcfg, tcfg, host,
                          f"interpret period {period}", backend="interpret")
        sw = next_counters(rng, jax.tree.map(jnp.asarray, sw), 16)


def test_controller_step_rack_shape():
    """The rack's report width: 32 servers x 64 lanes against C = 128,
    with keys repeated across servers (the summed merge)."""
    rng = np.random.default_rng(3)
    jcfg, tcfg = configs(active_size=128, max_size=128)
    host = tctl.CacheController(tcfg)
    sw = random_state(rng, cap=128, f=1, universe=600)
    reports = random_reports(rng, n_srv=32, k=64, universe=600)
    check_period(sw, reports, jcfg, tcfg, host, "rack shape")


def test_controller_step_install_live():
    """The spine mode: inserts go live at once with the reported value
    length; kept entries that were invalidated re-validate."""
    rng = np.random.default_rng(21)
    jcfg, tcfg = configs(active_size=10, min_size=2, max_size=16)
    cap = 16
    sw = random_state(rng, cap=cap)
    for period in range(3):
        reports = random_reports(rng)
        vlen = rng.integers(1, 1500, sum(len(k) for k, _ in reports)
                            ).astype(np.int32)
        want, got = both_steps(sw, reports, jcfg, tcfg, jcfg.active_size,
                               install_live=True, vlen=vlen)
        assert_trees_equal(got[0], want[0], f"install_live {period} state")
        assert_trees_equal(got[2], want[2], f"install_live {period} update")
        assert int(got[1]) == int(want[1])
        sw = next_counters(rng, jax.tree.map(jnp.asarray, want[0]), cap)
    sw_t = from_numpy(np_tree(sw), CPU)
    with pytest.raises(ValueError, match="report_vlen"):
        tctl.controller_step(
            sw_t, torch.full((4,), -1, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32), sw_t.counters.overflow,
            sw_t.counters.cached_reqs, torch.tensor(10, dtype=torch.int32),
            tcfg, install_live=True)


def test_configs_match():
    """The port's ControllerConfig has the reference's fields and
    defaults."""
    j = dataclasses.asdict(jctl.ControllerConfig())
    t = dataclasses.asdict(tctl.ControllerConfig())
    assert j == t
