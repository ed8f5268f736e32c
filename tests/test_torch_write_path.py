"""The write path's counts (``simulator.WRITE_PATH``): W-REQs that
invalidated a cached line, W-REPs that re-validated one, and reads
forwarded because their line was invalid.

A chunk records them a window, beside the metrics and never in them, and
``run`` returns them per call in ``SimResult.write_path``.  They
are held against counts recomputed from the JAX reference's own windows
on the same draws: its switch pass's ``stats`` (``n_w_cached``,
``n_invalid_fwd``) and its ingress lanes (W-REPs carrying a value whose
key the lookup table holds; with the F-REPs counted the same way they
make up ``stats.n_install``).  NetCache's counts are recomputed from the
reference's ``netcache_step`` inputs, subround by subround.

The port alone, and on the card: ``tests/test_torch_write_counts.py``.

Small shapes: 4 servers, C = 16, a 64-lane client batch, 5,000 keys,
values 64 B / 1,024 B at 95 / 5 %, writes at 0.2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import kernels as jkn  # noqa: E402
from repro.baselines import netcache as jnc  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.kvstore import simulator as jsim  # noqa: E402
from repro.kvstore import workload as jwl  # noqa: E402
from test_torch_simulator import TOL, jax_draws  # noqa: E402
from torch_parity import assert_trees_equal  # noqa: E402

from repro_torch.interop import (  # noqa: E402
    carry_from_numpy, fleet_carry_from_numpy)
from repro_torch.kvstore import client as tcl  # noqa: E402
from repro_torch.kvstore import fleet as tfl  # noqa: E402
from repro_torch.kvstore import simulator as tsim  # noqa: E402
from repro_torch.kvstore import workload as twl  # noqa: E402

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


@pytest.fixture(autouse=True)
def ref_backend():
    jkn.set_kernel_backend("ref")
    yield
    jkn.set_kernel_backend(None)


def preload_keys(scheme, wl):
    return wl.hottest_keys(RACK["cache_entries"] if scheme == "orbitcache"
                           else NETCACHE_KEYS)


# -- the reference's windows, recounted --------------------------------------
def cached(hkey, lookup_hkeys, occupied):
    """bool[...]: the lanes whose key hash is an occupied lookup entry."""
    keys = np.asarray(lookup_hkeys)[np.asarray(occupied)]
    return (np.asarray(hkey)[..., None, :] == keys).all(-1).any(-1)


def orbit_recount(sub, stats, lookup):
    """``(invalidations, validations, invalid_fwd, F-REP installs)`` of
    one reference window from its ingress ``sub``, its subrounds'
    ``stats`` and its lookup table (which only the controller changes)."""
    op, valid = np.asarray(sub.op), np.asarray(sub.valid)
    refresh = (valid & (np.asarray(sub.flag) >= 1)
               & cached(sub.hkey, lookup.hkeys, lookup.occupied))
    w_rep = int((refresh & (op == jtypes.OP_W_REP)).sum())
    f_rep = int((refresh & (op == jtypes.OP_F_REP)).sum())
    assert w_rep + f_rep == int(np.sum(stats.n_install))
    return (int(np.sum(stats.n_w_cached)), w_rep,
            int(np.sum(stats.n_invalid_fwd)), f_rep)


def netcache_recount(st, sub):
    """The same counts of one NetCache window, subround by subround from
    the table each subround sees (no F-REPs: NetCache preloads on the
    host)."""
    out = np.zeros(4, np.int64)
    for r in range(sub.op.shape[0]):
        pk = jax.tree.map(lambda a: a[r], sub)
        op, valid = np.asarray(pk.op), np.asarray(pk.valid)
        slot = np.asarray(jnc._match(st, pk.hkey))
        hit = (slot >= 0) & valid
        entry_valid = np.asarray(st.valid)[np.maximum(slot, 0)] & hit
        refresh = hit & (np.asarray(pk.flag) >= 1)
        out += [int((hit & (op == jtypes.OP_W_REQ)).sum()),
                int((refresh & (op == jtypes.OP_W_REP)).sum()),
                int((hit & (op == jtypes.OP_R_REQ) & ~entry_valid).sum()),
                0]
        st = jnc.netcache_step(st, pk)[0]
    return tuple(int(v) for v in out)


def reference_windows(ref, n):
    """Step the reference rack ``ref`` ``n`` windows, one jitted window at
    a time: each window's recount, ``int64[n, 4]``."""
    c = ref.cfg

    @jax.jit
    def window(wl, carry):
        sub = jsim.generate_ingress(c, ref.client_cfg, wl, carry)[3]
        new, m = jsim.window_step(c, ref.server_cfg, ref.client_cfg,
                                  ref.key_size, wl, carry)
        if c.scheme != "orbitcache":
            return new, m, sub, ()
        _, outs, _ = jpipe.window_pipeline(
            carry.policy, sub, recirc_gbps=c.recirc_gbps,
            window_us=c.window_us, subrounds=c.subrounds,
            max_serves=c.max_serves, key_size=ref.key_size)
        return new, m, sub, outs.stats

    counts = []
    for _ in range(n):
        before = ref.carry
        ref.carry, _, sub, stats = window(ref.wl.arrays, before)
        if c.scheme == "orbitcache":
            counts.append(orbit_recount(sub, stats, before.policy.lookup))
        else:
            counts.append(netcache_recount(before.policy, sub))
    return np.array(counts, np.int64)


def reference_rack(scheme, seed, offered):
    """A reference rack and its workload, and the port's draws of it
    (``ReplayDraws`` of its ``jax.random`` stream)."""
    wl_j = jwl.Workload(jwl.WorkloadConfig(**WORKLOAD))
    ref = jsim.RackSimulator(jsim.RackConfig(**dict(RACK, scheme=scheme,
                                                    seed=seed)), wl_j)
    ref.set_offered(offered)
    n = PRELOAD + WINDOWS
    draws = tcl.ReplayDraws(*jax_draws(seed, ref.carry.offered,
                                       RACK["client_batch"], n), CPU)
    return ref, wl_j, draws


def preload_reference(ref, keys):
    """The reference's preload, its OrbitCache windows recounted (as
    :func:`reference_windows`; ``[0, 4]`` for NetCache)."""
    if ref.cfg.scheme != "orbitcache":
        ref.preload(keys)
        return np.zeros((0, 4), np.int64)
    sw, fetches = ref.controller.preload(ref.carry.policy, keys)
    ref.carry = ref.carry._replace(policy=sw)
    ref.inject_fetches(fetches)
    return reference_windows(ref, PRELOAD)


def port_counts(res):
    wp = res.write_path
    return np.stack([wp[k] for k in tsim.WRITE_PATH], axis=1)


@pytest.mark.parametrize("scheme", ("orbitcache", "netcache"))
def test_rack_counts_match_the_reference(scheme):
    """One rack: every window's three counts equal the reference's
    recount on the same draws, and the carries stay equal."""
    ref, wl_j, draws = reference_rack(scheme, RACK["seed"],
                                      WORKLOAD["offered_rps"])
    port = tsim.RackSimulator(
        tsim.RackConfig(**RACK, scheme=scheme),
        twl.Workload(twl.WorkloadConfig(**WORKLOAD), device="cpu"),
        device="cpu", draws=draws)
    port.carry = carry_from_numpy(jax.tree.map(np.asarray, ref.carry), draws,
                                  CPU)
    keys = preload_keys(scheme, wl_j)
    want_pre = preload_reference(ref, keys)
    port.preload(keys)
    if scheme == "orbitcache":
        # the preload's F-REPs install lines: none counts as a validation
        assert want_pre[:, 3].sum() > 0
        np.testing.assert_array_equal(port.chunk.write_path(PRELOAD),
                                      want_pre[:, :3])
    want = reference_windows(ref, WINDOWS)
    got = port_counts(port.run(WINDOWS * 100e-6, chunk_windows=CHUNK))
    assert got.dtype == np.int32 and got.shape == (WINDOWS, 3)
    np.testing.assert_array_equal(got, want[:, :3])
    assert (want[:, :3].sum(axis=0) > 0).all(), want.sum(axis=0)
    assert_trees_equal(port.carry, ref.carry, f"{scheme} carry",
                       tolerate=TOL)


def test_fleet_counts_match_the_reference():
    """A fleet of 3 OrbitCache points: each point's counts equal its own
    reference rack's recount (seed and offered rate of its own)."""
    refs = [reference_rack("orbitcache", s, o)
            for s, o in zip(SEEDS, OFFERED)]
    cfg = tsim.RackConfig(**RACK)
    wl_t = twl.Workload(twl.WorkloadConfig(**WORKLOAD), device="cpu")
    draws = [d for _, _, d in refs]
    fleet = tfl.BatchedRackSimulator(cfg, wl_t, offered_rps=OFFERED,
                                     seeds=SEEDS, device="cpu", draws=draws)
    carries = [jax.tree.map(np.asarray, r.carry) for r, _, _ in refs]
    fleet.carry = fleet_carry_from_numpy(
        jax.tree.map(lambda *xs: np.stack(xs), *carries), draws, CPU)
    keys = preload_keys("orbitcache", refs[0][1])
    want_pre = [preload_reference(r, keys) for r, _, _ in refs]
    fleet.preload([keys] * len(SEEDS))
    got_pre = fleet.chunk.write_path(PRELOAD)
    assert got_pre.shape == (PRELOAD, len(SEEDS), 3)
    res = fleet.run(WINDOWS * 100e-6, chunk_windows=CHUNK)
    for i, (r, _, _) in enumerate(refs):
        np.testing.assert_array_equal(got_pre[:, i], want_pre[i][:, :3],
                                      err_msg=f"point {i} preload")
        want = reference_windows(r, WINDOWS)[:, :3]
        np.testing.assert_array_equal(port_counts(res[i]), want,
                                      err_msg=f"point {i}")
        assert (want.sum(axis=0) > 0).all(), (i, want.sum(axis=0))
