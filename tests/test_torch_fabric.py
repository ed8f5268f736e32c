"""The port's spine fabric (``repro_torch.core.fabric``,
``repro_torch.kvstore.fabric_sim``) against the JAX reference.

* The primitives (key homing, the target rule, slot compaction and the two
  lane exchanges) equal the reference's functions on seeded inputs,
  overflow and drop counts included.
* A whole fabric equals the reference's ``FabricSimulator`` for each spine
  scheme: the reference's preloaded carry crosses with
  ``interop.fabric_carry_from_numpy``, each rack replays the reference's
  ``jax.random`` client draws and the targets replay its ``draw_targets``
  draws (``(u, o)``; the rule itself runs in the port), and two controller
  periods of 4 windows at locality 0.5, tracking on, leave every trace and
  carry leaf equal (the latency histograms within
  ``test_torch_simulator.hist_close``).  ``spine_hop_us`` is 0.3 so that
  the float32 sites round.
* With native draws: locality 1.0 equals R independent port racks, the
  conservation laws of ``tests/test_fabric.py`` hold, and forwarded lanes
  reach their home racks.
* The three float32 sites equal the compiled reference's.

Small shapes, as ``tests/test_fabric.py``: C = 16, 2 servers, a 64-lane
batch, 2 subrounds, 2,000 keys.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import kernels as jkn  # noqa: E402
from repro.core import fabric as jfb  # noqa: E402
from repro.core.types import empty_batch as j_empty_batch  # noqa: E402
from repro.kvstore import client as jcl  # noqa: E402
from repro.kvstore import fabric_sim as jfs  # noqa: E402
from repro.kvstore import simulator as jsim  # noqa: E402
from repro.kvstore import workload as jwl  # noqa: E402
from test_torch_simulator import hist_close  # noqa: E402
from torch_parity import assert_trees_equal  # noqa: E402

from repro_torch import kernels as kn  # noqa: E402
from repro_torch.core import fabric as tfb  # noqa: E402
from repro_torch.core.types import empty_batch  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    fabric_carry_from_numpy, from_numpy, to_numpy,
)
from repro_torch.kvstore import client as tcl  # noqa: E402
from repro_torch.kvstore import fabric_sim as tfs  # noqa: E402
from repro_torch.kvstore import simulator as tsim  # noqa: E402
from repro_torch.kvstore import workload as twl  # noqa: E402

RACK = dict(cache_entries=16, num_servers=2, client_batch=64, fetch_lanes=16,
            value_pad=64, server_queue=16, subrounds=2)
WORKLOAD = dict(num_keys=2000, offered_rps=8e5)
CPU = torch.device("cpu")
RNG = np.random.default_rng(7)


def per_rack_hist(got, want, path):
    """``hist_close`` of each rack's (or point's) histogram."""
    if want.ndim == 1:
        return hist_close(got, want, path)
    for i in range(want.shape[0]):
        per_rack_hist(got[i], want[i], f"{path}[{i}]")


TOL = {".hist_switch": per_rack_hist, ".hist_server": per_rack_hist}


def workload(**kw):
    return twl.Workload(twl.WorkloadConfig(**dict(WORKLOAD, **kw)),
                        device="cpu")


def rack_draws(key, offered, b, n):
    """A reference rack's client draws from its PRNG key ``key``
    (``simulator.generate_requests``, ``client.generate``)."""
    ns, us, ws = [], [], []
    for _ in range(n):
        key, r_gen = jax.random.split(key)
        r1, r2, r3 = jax.random.split(r_gen, 3)
        ns.append(np.asarray(jax.random.poisson(r1, offered)))
        us.append(np.asarray(jax.random.uniform(r2, (b,), jnp.float32)))
        ws.append(np.asarray(jax.random.uniform(r3, (b,), jnp.float32)))
    return np.stack(ns), np.stack(us), np.stack(ws)


def target_draws(key, n_racks, shape, n):
    """The reference's ``draw_targets`` draws ``(u, o)`` from its
    ``fabric_rng`` ``key`` (``fabric_sim.py:182``, ``fabric.py:78-80``)."""
    us, os_ = [], []
    for _ in range(n):
        key, h_rng = jax.random.split(key)
        r_loc, r_oth = jax.random.split(h_rng)
        us.append(np.asarray(jax.random.uniform(r_loc, shape, jnp.float32)))
        os_.append(np.asarray(jax.random.randint(r_oth, shape, 0,
                                                 n_racks - 1, jnp.int32)))
    return np.stack(us), np.stack(os_)


def replayed_draws(carry, rack, fcfg, n):
    """A ``FabricDraws`` replaying the reference fabric ``carry``'s next
    ``n`` windows (racks and targets)."""
    b = rack["client_batch"]
    shape = (fcfg.n_racks, rack["subrounds"], (b + 64) // rack["subrounds"])
    racks = [tcl.ReplayDraws(*rack_draws(carry.racks.rng[i], np.asarray(
        carry.racks.offered[i]), b, n), CPU) for i in range(fcfg.n_racks)]
    return tfs.FabricDraws(racks, tfs.ReplayTargets(
        *target_draws(carry.fabric_rng, fcfg.n_racks, shape, n), CPU))


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def test_global_key_roundtrip():
    kidx = RNG.integers(-1, 10_000, 256).astype(np.int32)
    home = RNG.integers(0, 5, 256).astype(np.int32)
    gk = tfb.global_key(torch.from_numpy(kidx), torch.from_numpy(home), 5)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(jfb.global_key(
        jnp.asarray(kidx), jnp.asarray(home), 5)))
    for got, want in zip(tfb.split_global_key(gk, 5),
                         jfb.split_global_key(jnp.asarray(gk.numpy()), 5)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lk, h = tfb.split_global_key(gk, 5)
    np.testing.assert_array_equal(lk.numpy(), kidx)
    np.testing.assert_array_equal(h.numpy(), home)


def test_target_draws_locality_extremes():
    """Native draws: locality 1.0 keeps every lane local, 0.0 none; one
    rack takes no draw and targets itself."""
    shape = (4, 2, 64)
    src = np.arange(4)[:, None, None]
    targets = tfs.TorchTargets(0, 4, CPU)
    u, o = targets.draw(shape)
    assert u.dtype == torch.float32 and o.dtype == torch.int32
    pick = lambda f: tfb.targets_from_draws(
        u, o, 4, torch.tensor(f, dtype=torch.float32), shape, CPU).numpy()
    assert (pick(1.0) == src).all()
    t0 = pick(0.0)
    assert (t0 != src).all() and t0.min() >= 0 and t0.max() < 4
    tm = pick(0.5)
    assert (tm == src).any() and (tm != src).any()
    # the port's rule on the reference's own draws gives its targets
    key = jax.random.PRNGKey(3)
    ju, jo = (x[0] for x in target_draws(key, 4, shape, 1))
    for frac in (0.0, 0.3, 1.0):
        want = jfb.draw_targets(jax.random.split(key)[1], 4,
                                jnp.float32(frac), shape)
        got = tfb.targets_from_draws(
            torch.from_numpy(ju), torch.from_numpy(jo), 4,
            torch.tensor(frac, dtype=torch.float32), shape, CPU)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fd = tfs.FabricDraws([tcl.TorchDraws(0, CPU)], targets)
    state = targets.get_state()
    assert fd.draw_window(torch.zeros(1), 8, (1, 2, 64))[3:] == (None, None)
    assert torch.equal(targets.get_state(), state), "one rack drew targets"
    one = tfb.targets_from_draws(None, None, 1, torch.tensor(0.3),
                                 (1, 2, 8), CPU)
    assert (one.numpy() == 0).all()


@pytest.mark.parametrize("n,width", [(8, 3), (8, 8), (200, 32), (64, 64)])
def test_compact_slots_matches_reference(n, width):
    for density in (0.1, 0.5, 0.9):
        mask = RNG.random(n) < density
        got = tfb.compact_slots(torch.from_numpy(mask), width)
        want = jfb.compact_slots(jnp.asarray(mask), width)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype
            np.testing.assert_array_equal(g.numpy(), w)


def packets(r, s, lanes, pad=16):
    """Seeded reference and port request rows ``[R, S, L]``."""
    k = r * s * lanes
    cols = dict(op=RNG.integers(0, 2, k), seq=RNG.integers(0, 1000, k),
                kidx=np.arange(k), vlen=RNG.integers(0, 64, k),
                client=RNG.integers(0, 4, k), server=RNG.integers(0, 4, k),
                flag=RNG.integers(0, 3, k))
    pk = j_empty_batch(k, value_pad=pad)
    pk = pk._replace(
        **{f: jnp.asarray(v, jnp.int32) for f, v in cols.items()},
        hkey=jnp.asarray(RNG.integers(0, 2**32, (k, 4)), jnp.uint32),
        ts=jnp.asarray(RNG.random(k) * 100, jnp.float32),
        valid=jnp.asarray(RNG.random(k) < 0.8),
        val=jnp.asarray(RNG.integers(0, 256, (k, pad)), jnp.uint8))
    ref = jax.tree.map(lambda a: a.reshape((r, s, lanes) + a.shape[1:]), pk)
    port = from_numpy(jax.tree.map(np.asarray, ref), CPU)
    return ref, port


@pytest.mark.parametrize("w_spine,w_fwd", [(16, 8), (6, 2)])
def test_exchanges_match_reference(w_spine, w_fwd):
    """``exchange_to_spine`` and ``exchange_to_racks`` (and through them
    ``racks_to_rows`` and ``gather_lanes``) equal the reference's, with and
    without overflow."""
    r, s, lanes = 3, 2, 8
    ref, port = packets(r, s, lanes)
    tgt = RNG.integers(0, r, (r, s, lanes)).astype(np.int32)
    remote = (RNG.random((r, s, lanes)) < 0.5) & (
        tgt != np.arange(r)[:, None, None])
    j_sp = jax.jit(jfb.exchange_to_spine)(
        ref, jnp.asarray(remote), j_empty_batch(w_spine, value_pad=16))
    t_sp = tfb.exchange_to_spine(port, torch.from_numpy(remote),
                                 empty_batch(w_spine, 16, CPU))
    assert_trees_equal(t_sp[0], j_sp[0], "spine rows")
    for g, w in zip(t_sp[1:], j_sp[1:]):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
    home = RNG.integers(0, r, (s, w_spine)).astype(np.int32)
    fwd = np.asarray(j_sp[0].valid) & (RNG.random((s, w_spine)) < 0.7)
    j_fw = jax.jit(jfb.exchange_to_racks, static_argnums=3)(
        j_sp[0], jnp.asarray(fwd), jnp.asarray(home), r,
        j_empty_batch(w_fwd, value_pad=16))
    t_fw = tfb.exchange_to_racks(t_sp[0], torch.from_numpy(fwd),
                                 torch.from_numpy(home), r,
                                 empty_batch(w_fwd, 16, CPU))
    assert_trees_equal(t_fw[0], j_fw[0], "rack forward rows")
    assert int(t_fw[1]) == int(j_fw[1])
    if w_fwd == 2:
        assert int(t_fw[1]) > 0 and int(t_sp[3]) > 0, "no overflow case"


# ---------------------------------------------------------------------------
# the whole fabric against the reference
# ---------------------------------------------------------------------------
CASES = {"orbitcache": "orbitcache", "netcache": "nocache",
         "nocache": "netcache"}        # spine scheme -> rack scheme


def fabric_cfg(spine, **kw):
    base = dict(n_racks=3, local_frac=0.5, spine_scheme=spine,
                spine_lanes=64, fwd_lanes=32, spine_cache_entries=32,
                spine_netcache_entries=40, spine_k_report=8,
                spine_hop_us=0.3)
    return base | kw


@pytest.mark.parametrize("spine", list(CASES))
def test_fabric_matches_jax(spine):
    """A preloaded reference fabric carried across, then two periods of 4
    windows through ``run_periods`` (racks tracking, the spine controller
    in ``install_live`` mode where OrbitCache): every trace, carry leaf and
    active size equal."""
    rack = dict(RACK, scheme=CASES[spine], track_popularity=True,
                netcache_entries=40, netcache_value_limit=64)
    fkw = fabric_cfg(spine)
    wl_kw = dict(WORKLOAD, write_ratio=0.1)
    jkn.set_kernel_backend("ref")
    try:
        ref = jfs.FabricSimulator(jsim.RackConfig(**rack),
                                  jfs.FabricConfig(**fkw),
                                  jwl.Workload(jwl.WorkloadConfig(**wl_kw)))
        ref.preload(warm_windows=0)
        carry = jax.tree.map(np.asarray, ref.carry)
        draws = replayed_draws(ref.carry, rack, jfs.FabricConfig(**fkw), 8)
        port = tfs.FabricSimulator(tsim.RackConfig(**rack),
                                   tfs.FabricConfig(**fkw),
                                   workload(write_ratio=0.1), device="cpu",
                                   draws=draws)
        port.preload(warm_windows=0)
        assert_trees_equal(port.carry, carry._replace(fabric_rng=()),
                           f"{spine} preload", tolerate=TOL)
        port.carry = fabric_carry_from_numpy(carry, draws, CPU)
        m_ref = ref.run_periods(2, 4)
    finally:
        jkn.set_kernel_backend(None)
    m_port = port.run_periods(2, 4)
    assert set(m_port) == set(m_ref)
    for k, v in m_ref.items():
        v = np.asarray(v)
        assert m_port[k].dtype == v.dtype, k
        np.testing.assert_array_equal(m_port[k], v, err_msg=f"{spine}: {k}")
    assert_trees_equal(port.carry, ref.carry._replace(fabric_rng=()),
                       f"{spine} carry", tolerate=TOL)
    assert [c.active_size for c in port.controllers] == \
        [c.active_size for c in ref.controllers]
    assert port.spine_controller.active_size == \
        ref.spine_controller.active_size
    assert m_port["spine_remote"].sum() > 0 and m_port["spine_fwd"].sum() > 0
    if spine != "nocache":
        assert m_port["spine_served"].sum() > 0


@pytest.mark.parametrize("spine", ["orbitcache", "netcache"])
def test_preload_spine_matches_reference(spine):
    """The global hot set, rank-interleaved over 4 racks and truncated."""
    fkw = dict(n_racks=4, spine_scheme=spine, spine_cache_entries=30,
               spine_netcache_entries=30)
    jcfg, tcfg = jsim.RackConfig(**RACK), tsim.RackConfig(**RACK)
    want = jfs.preload_spine(
        jfs.init_spine_policy(jcfg, jfs.FabricConfig(**fkw)), jcfg,
        jfs.FabricConfig(**fkw), jwl.Workload(jwl.WorkloadConfig(**WORKLOAD)))
    got = tfs.preload_spine(
        tfs.init_spine_policy(tcfg, tfs.FabricConfig(**fkw), CPU), tcfg,
        tfs.FabricConfig(**fkw), workload())
    assert_trees_equal(got, want, f"{spine} spine")
    occ = got.lookup.occupied if spine == "orbitcache" else got.occupied
    kidx = got.lookup.kidx if spine == "orbitcache" else got.kidx
    assert set((kidx[occ] % 4).tolist()) == {0, 1, 2, 3}


# ---------------------------------------------------------------------------
# native draws: the reference's topology guarantees
# ---------------------------------------------------------------------------
def test_locality_one_equals_independent_racks():
    """At locality 1.0 rack i of a fabric is the port rack of seed
    ``cfg.seed + i`` leaf for leaf, through the preload, its warm-up and 6
    windows; the spine sees nothing."""
    cfg = tsim.RackConfig(**RACK, scheme="orbitcache", seed=3)
    fcfg = tfs.FabricConfig(**fabric_cfg("orbitcache", local_frac=1.0))
    wl = workload(write_ratio=0.05)
    fab = tfs.FabricSimulator(cfg, fcfg, wl, device="cpu")
    fab.preload()
    out = fab.run_windows(6)
    for i in range(fcfg.n_racks):
        sim = tsim.RackSimulator(dataclasses.replace(cfg, seed=3 + i), wl,
                                 device="cpu")
        sim.preload(wl.hottest_keys(cfg.cache_entries))
        want = sim.run_windows(6)
        for k, v in want.items():
            np.testing.assert_array_equal(out[f"rack_{k}"][:, i], v,
                                          err_msg=f"rack {i}: {k}")
        assert_trees_equal(tsim.tree_take(fab.carry.racks, i),
                           to_numpy(sim.carry), f"rack {i}")
    for k in ("spine_remote", "spine_fwd", "spine_in_drops",
              "spine_fwd_drops"):
        assert out[k].sum() == 0, k
    assert out["rack_tx"].sum() > 0


@pytest.mark.parametrize("spine", ["orbitcache", "netcache", "nocache"])
def test_remote_traffic_conservation(spine):
    """``tests/test_fabric.py``'s laws, per window: nocache ``fwd +
    in_drops == remote``; netcache ``served + fwd + in_drops == remote``;
    orbitcache ``fwd + in_drops <= remote`` and serves bounded by remote
    plus the spine queues, every serve accounted at the spine tier."""
    cfg = tsim.RackConfig(**RACK, scheme="orbitcache")
    fcfg = tfs.FabricConfig(**fabric_cfg(
        spine, spine_lanes=96, fwd_lanes=96, spine_hop_us=2.0,
        spine_netcache_entries=10_000))
    sim = tfs.FabricSimulator(cfg, fcfg, workload(), device="cpu")
    sim.preload(warm_windows=2)
    rx0 = int(sim.carry.spine_clients.rx_switch)
    out = sim.run_windows(8)
    remote, served, fwd, in_drops = (out[k].astype(np.int64) for k in (
        "spine_remote", "spine_served", "spine_fwd", "spine_in_drops"))
    assert remote.sum() > 0
    if spine == "nocache":
        assert served.sum() == 0
        np.testing.assert_array_equal(fwd + in_drops, remote)
    elif spine == "netcache":
        assert fwd.sum() > 0 and served.sum() > 0
        np.testing.assert_array_equal(served + fwd + in_drops, remote)
    else:
        assert fwd.sum() > 0
        assert (fwd + in_drops <= remote).all()
        assert served.sum() <= remote.sum() + 32 * 8
        assert served.sum() == int(sim.carry.spine_clients.rx_switch) - rx0


def test_forwarded_lanes_reach_their_home_racks():
    """NoCache racks under a NoCache spine: each rack's server-bound lanes
    are its local requests plus the lanes forwarded to it, every window
    (the remote requests leave their source rack, the forwarded ones
    arrive at the home rack, the dropped ones vanish)."""
    cfg = tsim.RackConfig(**RACK, scheme="nocache")
    fcfg = tfs.FabricConfig(**fabric_cfg("nocache", n_racks=2,
                                         spine_lanes=128, fwd_lanes=64))
    sim = tfs.FabricSimulator(cfg, fcfg, workload(), device="cpu")
    out = sim.run_windows(8)
    to_server = out["rack_fwd"].astype(np.int64).sum(1)
    tx = out["rack_tx"].astype(np.int64).sum(1)
    np.testing.assert_array_equal(
        to_server, tx - out["spine_remote"] + out["spine_fwd"]
        - out["spine_fwd_drops"])
    assert out["spine_fwd"].sum() > 0 and out["rack_served"].sum() > 0


def test_set_local_frac_between_chunks():
    """``local_frac`` is a carry scalar, copied in at the next chunk's
    start: a fabric at 1.0 sends nothing to the spine, then at 0.5 it
    does, through the same chunk."""
    cfg = tsim.RackConfig(**RACK, scheme="nocache")
    fcfg = tfs.FabricConfig(**fabric_cfg("nocache", local_frac=1.0))
    sim = tfs.FabricSimulator(cfg, fcfg, workload(), device="cpu")
    assert sim.run_windows(4)["spine_remote"].sum() == 0
    chunk = sim.chunk
    sim.set_local_frac(0.5)
    assert sim.run_windows(4)["spine_remote"].sum() > 0
    assert sim.chunk is chunk and float(sim.carry.local_frac) == 0.5


# ---------------------------------------------------------------------------
# the float32 sites against the compiled reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window,subrounds,hop", [(100.0, 4, 2.0),
                                                  (100.0, 2, 0.3),
                                                  (37.5, 8, 1.7)])
def test_spine_float32_sites_match_compiled_reference(window, subrounds,
                                                      hop):
    """The spine serve time, the fall-through timestamp and the NetCache
    spine latency (``fabric_sim.py:216-222``, ``:269``, ``:241-242``,
    verbatim and jitted) against the port's, bit for bit, over 10^5
    random times."""
    n, c, j = 100_000 // (subrounds * 8), 8, 8
    rng = np.random.default_rng(subrounds)
    now = np.float32(rng.random() * 1e5)
    order = rng.integers(0, j, (subrounds, c, j)).astype(np.int32)
    intervals = (rng.random(subrounds) * 3).astype(np.float32)
    ts = (rng.random(n) * 1e5).astype(np.float32)
    base_rtt = jcl.ClientConfig().base_rtt_us

    def reference(now, order, intervals, ts):
        win, hop_ = jnp.float32(window), jnp.float32(hop)
        r_idx = jnp.arange(subrounds, dtype=jnp.float32)[:, None, None]
        serve_time = (now + 2.0 * hop_ + (r_idx + 0.5) * win / subrounds
                      + (order.astype(jnp.float32) + 1.0)
                      * intervals[:, None, None])
        lat = jnp.full(ts.shape, 1.0, jnp.float32) + base_rtt + 2.0 * hop_
        return serve_time, ts - 4.0 * hop_, lat

    want = [np.asarray(x) for x in jax.jit(reference)(now, order, intervals,
                                                      ts)]
    got = [tfs.spine_serve_time(torch.tensor(now), torch.from_numpy(order),
                                torch.from_numpy(intervals), window, hop),
           tfs.fall_through_ts(torch.from_numpy(ts), hop),
           tfs.spine_switch_latency(ts.shape, base_rtt, hop, CPU)]
    for name, g, w in zip(("serve_time", "fall_through", "latency"), got,
                          want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


# ---------------------------------------------------------------------------
# argument rules and the device
# ---------------------------------------------------------------------------
def test_fabric_argument_rules():
    cfg = tsim.RackConfig(**RACK)
    wl = workload()
    with pytest.raises(ValueError, match="multiples of subrounds"):
        tfs.FabricSimulator(cfg, tfs.FabricConfig(spine_lanes=65), wl,
                            device="cpu")
    with pytest.raises(ValueError, match="need 4 seeds"):
        tfs.FabricSimulator(cfg, tfs.FabricConfig(), wl, seeds=[1, 2],
                            device="cpu")
    sim = tfs.FabricSimulator(cfg, tfs.FabricConfig(n_racks=2), wl,
                              device="cpu")
    assert [s.gen.initial_seed() for s in sim.carry.draws.racks.sources] == \
        [cfg.seed, cfg.seed + 1]
    assert sim.carry.draws.targets.gen.initial_seed() == cfg.seed + 0x0FAB
    assert sim.spine_controller.cfg.k_report == 16


def test_fabric_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfs.FabricSimulator(tsim.RackConfig(**RACK), tfs.FabricConfig(),
                            workload())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("spine", ["orbitcache", "netcache"])
def test_fabric_graphed_equals_eager(spine):
    """A fabric chunk replayed as CUDA graphs equals the eager chunk, leaf
    for leaf: 6 windows, then a period of 4, from one carry and
    generator state; each kernel once per call site a window (racks and
    spine), none of them a plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = tsim.RackConfig(**RACK, track_popularity=True)
    fcfg = tfs.FabricConfig(**fabric_cfg(spine))
    wl = twl.Workload(twl.WorkloadConfig(**WORKLOAD), device=dev)
    sim = tfs.FabricSimulator(cfg, fcfg, wl)
    sim.preload()
    start = tsim.tree_map(torch.clone, sim.carry)
    state = sim.carry.draws.get_state()
    runs = []
    for graphs in (True, False):
        sim.carry = tsim.tree_map(torch.clone, start)
        sim.carry.draws.set_state(state)
        sim.chunk.graphs = graphs
        kn.reset_launch_counts()
        out = [sim.run_windows(6), sim.run_periods(1, 4)]
        runs.append((out, to_numpy(sim.carry), dict(kn.LAUNCHES)))
    (g, cg, lg), (e, ce, le) = runs
    for a, b in zip(g, e):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert_trees_equal(cg, ce, "graphed vs eager")
    per_window = 2 if spine == "orbitcache" else 1
    assert lg == le == dict(subround=10 * per_window * cfg.subrounds,
                            cms=10, hot_gather=3 * per_window,
                            orbit_match=0, reply_values=10,
                            server_enqueue=10)
