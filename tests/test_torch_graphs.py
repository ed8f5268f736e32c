"""The port's chunk (``CompiledChunk``) against the reference's compiled
chunk and against a plain loop of windows.

On the CPU a chunk calls its window body (and, with a controller period,
its period body) once per window; on the card it replays them as CUDA
graphs.  Both must give what the reference's jitted ``lax.scan`` gives:
every metric, every carry leaf, every period's ``TracedUpdate`` and
``active_size``, including when the host changes the carry or the
workload between chunks.  The port replays the reference's ``jax.random``
draws, so everything is exact but for the latency histograms' stated
``log2`` tolerance (``test_torch_simulator.hist_close``).

Small shapes: 4 servers, C = 8, a 16-lane client batch, ``value_pad`` 16.
The ``cuda``-marked tests hold the graphed chunk against the eager one on
the card and skip without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import kernels as jkn  # noqa: E402
from repro.core import controller as jctl  # noqa: E402
from repro.kvstore import simulator as jsim  # noqa: E402
from repro.kvstore import workload as jwl  # noqa: E402
from test_torch_simulator import hist_close  # noqa: E402
from torch_parity import assert_trees_equal  # noqa: E402

from repro_torch import kernels as kn  # noqa: E402
from repro_torch.core import controller as tctl  # noqa: E402
from repro_torch.interop import carry_from_numpy, to_numpy  # noqa: E402
from repro_torch.kvstore import client as tcl  # noqa: E402
from repro_torch.kvstore import fleet as tfl  # noqa: E402
from repro_torch.kvstore import simulator as tsim  # noqa: E402
from repro_torch.kvstore import workload as twl  # noqa: E402

RACK = dict(num_servers=4, cache_entries=8, client_batch=16, value_pad=16,
            subrounds=4, fetch_lanes=8, netcache_table=64,
            netcache_value_limit=16, seed=5)
WORKLOAD = dict(num_keys=2000, offered_rps=0.12e6, write_ratio=0.1,
                value_sizes=((16, 0.5), (48, 0.3), (1024, 0.2)))
SCHEMES = ("orbitcache", "netcache", "nocache")
CHUNK = 6              # windows a chunk (one reference compilation)
HIGH_RPS = 0.2e6       # offered after ``set_offered``
TOL = {".hist_switch": hist_close, ".hist_server": hist_close}
CPU = torch.device("cpu")


def jax_draws(seed, offered):
    """The reference's per-window draws (``simulator.py:321``,
    ``client.py:131-144``) for windows offered ``offered[i]`` requests."""
    rng = jax.random.PRNGKey(seed)
    ns, us, ws = [], [], []
    b = RACK["client_batch"]
    for lam in offered:
        rng, r_gen = jax.random.split(rng)
        r1, r2, r3 = jax.random.split(r_gen, 3)
        ns.append(np.asarray(jax.random.poisson(r1, jnp.float32(lam))))
        us.append(np.asarray(jax.random.uniform(r2, (b,), jnp.float32)))
        ws.append(np.asarray(jax.random.uniform(r3, (b,), jnp.float32)))
    return np.stack(ns), np.stack(us), np.stack(ws)


def per_window(rps):
    return np.float32(rps * 100.0 * 1e-6)


def plain_windows(sim, n):
    """The eager loop ``run_windows`` ran before the chunk: ``window_step``
    n times on fresh tensors, the metrics stacked at the end."""
    carry, ys = sim.carry, []
    for _ in range(n):
        carry, m = tsim.window_step(sim.cfg, sim.server_cfg, sim.client_cfg,
                                    sim.key_size, sim.wl.arrays, carry)
        ys.append(m)
    sim.carry = carry
    return {k: to_numpy(torch.stack([getattr(m, k) for m in ys]), k)
            for k in tsim.WindowMetrics._fields}


def assert_metrics_equal(got, want, label):
    assert set(got) == set(want), label
    for k, v in want.items():
        assert got[k].dtype == v.dtype, (label, k)
        np.testing.assert_array_equal(got[k], v, err_msg=f"{label}: {k}")


def three_racks(rack, n_windows, offered, controller_cfg=None):
    """The reference, the port (its chunk) and a plain port loop, from one
    carry and one set of draws: ``(ref, port, plain, wl_j, wl_t)``."""
    rcfg = jsim.RackConfig(**rack)
    wl_j = jwl.Workload(jwl.WorkloadConfig(**WORKLOAD))
    wl_t = twl.Workload(twl.WorkloadConfig(**WORKLOAD), device="cpu")
    ref = jsim.RackSimulator(rcfg, wl_j)
    assert len(offered) == n_windows
    draws = jax_draws(rcfg.seed, offered)
    sims = []
    for _ in range(2):
        d = tcl.ReplayDraws(*draws, CPU)
        sim = tsim.RackSimulator(tsim.RackConfig(**rack), wl_t, device="cpu",
                                 draws=d)
        sim.carry = carry_from_numpy(jax.tree.map(np.asarray, ref.carry), d,
                                     CPU)
        sims.append(sim)
    port, plain = sims
    plain.run_windows = lambda n: plain_windows(plain, n)
    if controller_cfg is not None:
        ref.controller = jctl.CacheController(
            jctl.ControllerConfig(**controller_cfg))
        for sim in sims:
            sim.controller = tctl.CacheController(
                tctl.ControllerConfig(**controller_cfg))
    return ref, port, plain, wl_j, wl_t


@pytest.mark.parametrize("scheme", SCHEMES)
def test_chunk_matches_plain_loop_and_jax(scheme):
    """The preload, then three chunks of 6 windows, with ``set_offered``
    and ``inject_fetches`` before the second and ``reset_stats`` and
    ``hot_in_swap`` before the third: after each chunk the port's chunk
    equals the reference's ``compiled_chunk`` and the plain loop, in every
    metric and carry leaf."""
    rack = dict(RACK, scheme=scheme)
    n_pre = 16 if scheme == "orbitcache" else 0
    offered = ([per_window(WORKLOAD["offered_rps"])] * (n_pre + CHUNK)
               + [per_window(HIGH_RPS)] * (2 * CHUNK))
    ref, port, plain, wl_j, wl_t = three_racks(rack, len(offered), offered)
    keys = wl_j.hottest_keys(8)
    fetches = [(int(k), i) for i, k in enumerate(wl_j.hottest_keys(12)[8:])]
    jkn.set_kernel_backend("ref")
    try:
        for sim in (ref, port, plain):
            sim.preload(keys)
        assert_trees_equal(port.carry, ref.carry, "after preload",
                           tolerate=TOL)
        for i in range(3):
            if i == 1:
                for sim in (ref, port, plain):
                    sim.set_offered(HIGH_RPS)
                    sim.inject_fetches(fetches)
            if i == 2:
                for sim in (ref, port, plain):
                    sim.reset_stats()
                wl_j.hot_in_swap(8)
                wl_t.hot_in_swap(8)
            m_ref = {k: np.asarray(v)
                     for k, v in ref.run_windows(CHUNK).items()}
            m_port = port.run_windows(CHUNK)
            m_plain = plain.run_windows(CHUNK)
            label = f"{scheme} chunk {i}"
            assert_metrics_equal(m_port, m_ref, label)
            assert_metrics_equal(m_port, m_plain, label + " (plain loop)")
            assert_trees_equal(port.carry, ref.carry, label, tolerate=TOL)
            assert_trees_equal(port.carry, to_numpy(plain.carry),
                               label + " (plain loop)")
    finally:
        jkn.set_kernel_backend(None)
    assert m_ref["tx"].sum() > 0 and m_ref["fwd"].sum() > 0


def test_controller_chunk_matches_jax():
    """``run_periods`` against the reference's
    ``compiled_controller_chunk``: two chunks of 2 periods of 4 windows,
    server tracking on, dynamic sizing on (so ``active_size`` moves), with
    ``hot_in_swap``, ``set_offered`` and ``reset_stats`` between them.
    Every metric, carry leaf, period ``TracedUpdate`` and ``active_size``
    is equal."""
    rack = dict(RACK, track_popularity=True)
    ctrl = dict(active_size=6, min_size=2, max_size=8, size_step=2,
                overflow_threshold=0.01, dynamic_sizing=True, k_report=8)
    offered = ([per_window(WORKLOAD["offered_rps"])] * 24
               + [per_window(HIGH_RPS)] * 8)
    ref, port, _, wl_j, wl_t = three_racks(rack, 32, offered, ctrl)
    keys = wl_j.hottest_keys(8)
    sizes, inserted = [], 0
    jkn.set_kernel_backend("ref")
    try:
        ref.preload(keys)
        port.preload(keys)
        for i in range(2):
            if i:
                wl_j.hot_in_swap(8)
                wl_t.hot_in_swap(8)
                for sim in (ref, port):
                    sim.set_offered(HIGH_RPS)
                    sim.reset_stats()
            m_ref = {k: np.asarray(v)
                     for k, v in ref.run_periods(2, 4).items()}
            m_port = port.run_periods(2, 4)
            label = f"controller chunk {i}"
            assert_metrics_equal(m_port, m_ref, label)
            assert_trees_equal(port.carry, ref.carry, label, tolerate=TOL)
            assert_trees_equal(port._last_update, ref._last_update,
                               label + " updates")
            assert port.controller.active_size == ref.controller.active_size
            sizes.append(port.controller.active_size)
            inserted += int(ref._last_update.n_insert.sum())
    finally:
        jkn.set_kernel_backend(None)
    assert port._last_update.n_insert.shape == (2,)
    assert inserted > 0, "the controller never acted"
    assert sizes != [6, 6], "active_size never moved"


def test_replay_draws_checked_at_chunk_start():
    """A chunk that needs more recorded windows than are left raises
    before any window runs; the windows left still run after it."""
    wl = twl.Workload(twl.WorkloadConfig(**WORKLOAD), device="cpu")
    rng = np.random.default_rng(1)
    n = rng.poisson(10.0, 5)
    u, w = (rng.random((5, 16), dtype=np.float32) for _ in range(2))
    sim = tsim.RackSimulator(tsim.RackConfig(**RACK), wl, device="cpu",
                             draws=tcl.ReplayDraws(n, u, w, "cpu"))
    first = sim.run_windows(3)
    after = to_numpy(sim.carry)
    with pytest.raises(IndexError, match="3 windows asked for, 2 of 5 left"):
        sim.run_windows(3)
    assert_trees_equal(sim.carry, after, "after the refused chunk")
    last = sim.run_windows(2)
    np.testing.assert_array_equal(np.concatenate([first["tx"], last["tx"]]),
                                  np.minimum(n, 16))


def test_graphs_need_a_cuda_device():
    wl = twl.Workload(twl.WorkloadConfig(num_keys=100), device="cpu")
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        tsim.RackSimulator(tsim.RackConfig(**RACK), wl, device="cpu",
                           graphs=True)
    sim = tsim.RackSimulator(tsim.RackConfig(**RACK), wl, device="cpu")
    assert sim.chunk.graphs is False
    sim.chunk.graphs = True
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        sim.run_windows(1)


def test_chunk_reuses_the_carry_memory():
    """The carry a chunk returns is the chunk's own buffers (the
    reference donates its carry), so the next chunk overwrites it; a
    clone keeps it."""
    wl = twl.Workload(twl.WorkloadConfig(**WORKLOAD), device="cpu")
    sim = tsim.RackSimulator(tsim.RackConfig(**RACK), wl, device="cpu")
    sim.run_windows(2)
    held, kept = sim.carry, sim.carry.now.clone()
    sim.run_windows(2)
    assert sim.carry.now is held.now
    assert float(held.now) == 400.0 and float(kept) == 200.0


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
CARD_RACK = dict(RACK, cache_entries=16, client_batch=64)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; CUDA graphs have no CPU mode")
    return torch.device("cuda", 0)


def _card_pair(scheme, draws_kind, dev):
    """Two racks on the card from one carry and one draw state, one
    graphed and one eager: ``(graphed, eager, wl)``."""
    rack = dict(CARD_RACK, track_popularity=scheme == "control_plane",
                scheme="orbitcache" if scheme == "control_plane" else scheme)
    wl = twl.Workload(twl.WorkloadConfig(**WORKLOAD), device=dev)
    rng = np.random.default_rng(7)
    recorded = (rng.poisson(12.0, 64),
                *(rng.random((64, 64), dtype=np.float32) for _ in range(2)))
    sims = []
    for graphs in (True, False):
        d = (tcl.TorchDraws(3, dev) if draws_kind == "torch"
             else tcl.ReplayDraws(*recorded, dev))
        sims.append(tsim.RackSimulator(tsim.RackConfig(**rack), wl,
                                       draws=d, graphs=graphs))
    graphed, eager = sims
    if rack["scheme"] != "nocache":
        graphed.preload(wl.hottest_keys(16))
    eager.carry = tsim._clone_tree(graphed.carry)._replace(
        draws=eager.carry.draws)
    eager.carry.draws.set_state(graphed.carry.draws.get_state())
    eager.controller.active_size = graphed.controller.active_size
    if rack["scheme"] == "netcache":
        eager._installed = graphed._installed
    return graphed, eager, wl


def _drive(sim, scheme, wl, swap):
    """Two chunks, a ``hot_in_swap`` between them when ``swap``."""
    out = []
    for i in range(2):
        if i and swap:
            wl.hot_in_swap(8)
        if scheme == "control_plane":
            out.append(sim.run_periods(2, 5))
            out.append(sim._last_update._asdict())
        else:
            out.append(sim.run_windows(12))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("draws_kind", ["torch", "replay"])
@pytest.mark.parametrize("scheme", SCHEMES + ("control_plane",))
def test_graphed_chunk_matches_eager_on_card(scheme, draws_kind):
    """Graphed and eager chunks from one carry and one draw state (a
    private Philox generator, or recorded draws) are equal in every
    metric, carry leaf and period update, through a ``hot_in_swap``; the
    graphed run counts every captured kernel launch once per replay."""
    dev = _card()
    graphed, eager, wl = _card_pair(scheme, draws_kind, dev)
    perm0 = wl._perm_np.copy()
    kn.reset_launch_counts()
    got = _drive(graphed, scheme, wl, swap=True)
    torch.cuda.synchronize()
    launches = dict(kn.LAUNCHES)
    wl._perm_np[:] = perm0
    wl.perm = torch.from_numpy(perm0.copy()).to(dev)
    kn.reset_launch_counts()
    want = _drive(eager, scheme, wl, swap=True)
    torch.cuda.synchronize()
    assert launches == dict(kn.LAUNCHES)
    n_win = 2 * (10 if scheme == "control_plane" else 12)
    tracking = scheme == "control_plane"
    subround = 4 * n_win if scheme in ("orbitcache", "control_plane") else 0
    assert launches == dict(subround=subround, cms=n_win * tracking,
                            hot_gather=3 * 4 * tracking, orbit_match=0,
                            reply_values=n_win, server_enqueue=n_win)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{i}: {k}")
    assert_trees_equal(graphed.carry, to_numpy(eager.carry), "carry")
    assert graphed.chunk.captures >= 1 and eager.chunk.captures == 0


@pytest.mark.cuda
@pytest.mark.parametrize("graphs", [False, True])
@pytest.mark.parametrize("scheme", SCHEMES + ("control_plane",))
def test_chunk_does_not_sync(scheme, graphs):
    """No window and no period boundary waits for the card or copies from
    the host: a chunk runs under ``set_sync_debug_mode("error")`` (after a
    first chunk that captured the graphs)."""
    dev = _card()
    sim, _, wl = _card_pair(scheme, "torch", dev)
    sim.chunk.graphs = graphs
    run = ((lambda: sim.chunk.controller_chunk(
        wl.arrays, sim.carry, 8, sim.controller.cfg, 1, 4))
        if scheme == "control_plane"
        else (lambda: sim.chunk(wl.arrays, sim.carry, 4)))
    run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernel_backend_is_part_of_the_graph_key():
    """``set_kernel_backend("ref")`` recaptures the window graph with the
    plain versions (no kernel launch counted) and equals the kernel graph;
    back on the kernels, the chunk recaptures again."""
    dev = _card()
    graphed, eager, wl = _card_pair("orbitcache", "torch", dev)
    start = tsim._clone_tree(graphed.carry)
    state = graphed.carry.draws.get_state()
    kn.reset_launch_counts()
    want = graphed.run_windows(6)
    captures = graphed.chunk.captures
    graphed.carry = tsim._clone_tree(start)
    graphed.carry.draws.set_state(state)
    kn.set_kernel_backend("ref")
    try:
        got = graphed.run_windows(6)
    finally:
        kn.set_kernel_backend(None)
    assert graphed.chunk.captures == captures + 1
    assert kn.LAUNCHES["subround"] == 4 * 6
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    graphed.run_windows(6)
    assert graphed.chunk.captures == captures + 2
    assert kn.LAUNCHES["subround"] == 4 * 12


# the fleet: a window graph (and a period graph) of all points at once
FLEET_POINTS = 3


def _card_fleet_pair(scheme, dev):
    """Two 3-point fleets on the card from one carry and one draw state,
    one graphed and one eager: ``(graphed, eager, wl)``."""
    rack = dict(CARD_RACK, track_popularity=scheme == "control_plane",
                scheme="orbitcache" if scheme == "control_plane" else scheme)
    wl = twl.Workload(twl.WorkloadConfig(**WORKLOAD), device=dev)
    graphed, eager = (tfl.BatchedRackSimulator(
        tsim.RackConfig(**rack), wl, offered_rps=(0.1e6, 0.2e6, 0.4e6),
        graphs=graphs) for graphs in (True, False))
    if rack["scheme"] != "nocache":
        graphed.preload([wl.hottest_keys(16)] * FLEET_POINTS)
    eager.carry = tsim._clone_tree(graphed.carry)._replace(
        draws=eager.carry.draws)
    eager.carry.draws.set_state(graphed.carry.draws.get_state())
    return graphed, eager, wl


def _drive_fleet(fleet, scheme, wl):
    """Two chunks with a ``hot_in_swap`` between them."""
    out = []
    for i in range(2):
        if i:
            wl.hot_in_swap(8)
            fleet.refresh_workloads()
        if scheme == "control_plane":
            out.append(fleet.run_periods(2, 5))
            out.append(fleet._last_update._asdict())
            out.append(dict(active=np.array([c.active_size
                                             for c in fleet.controllers])))
        else:
            out.append(fleet.run_windows(12))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", SCHEMES + ("control_plane",))
def test_fleet_graphed_chunk_matches_eager_on_card(scheme):
    """A graphed fleet chunk equals an eager one from the same carry and
    draw states in every metric, carry leaf, period update and
    ``active_size``, through a ``hot_in_swap``; each kernel launches once
    per call site for all points."""
    dev = _card()
    graphed, eager, wl = _card_fleet_pair(scheme, dev)
    perm0 = wl._perm_np.copy()
    kn.reset_launch_counts()
    got = _drive_fleet(graphed, scheme, wl)
    torch.cuda.synchronize()
    launches = dict(kn.LAUNCHES)
    wl._perm_np[:] = perm0
    wl.perm = torch.from_numpy(perm0.copy()).to(dev)
    eager.refresh_workloads()
    kn.reset_launch_counts()
    want = _drive_fleet(eager, scheme, wl)
    torch.cuda.synchronize()
    assert launches == dict(kn.LAUNCHES)
    n_win = 2 * (10 if scheme == "control_plane" else 12)
    tracking = scheme == "control_plane"
    subround = 4 * n_win if scheme in ("orbitcache", "control_plane") else 0
    assert launches == dict(subround=subround, cms=n_win * tracking,
                            hot_gather=3 * 4 * tracking, orbit_match=0,
                            reply_values=n_win, server_enqueue=n_win)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{i}: {k}")
    assert_trees_equal(graphed.carry, to_numpy(eager.carry), "carry")
    assert got[0]["tx"].shape == (FLEET_POINTS, 10 if tracking else 12)
    assert graphed.chunk.captures >= 1 and eager.chunk.captures == 0


@pytest.mark.cuda
@pytest.mark.parametrize("graphs", [False, True])
@pytest.mark.parametrize("scheme", SCHEMES + ("control_plane",))
def test_fleet_chunk_does_not_sync(scheme, graphs):
    """No fleet window and no fleet period boundary waits for the card or
    copies from the host (``set_sync_debug_mode("error")``)."""
    dev = _card()
    fleet, _, wl = _card_fleet_pair(scheme, dev)
    fleet.chunk.graphs = graphs
    run = ((lambda: fleet.chunk.controller_chunk(
        fleet._wl, fleet.carry, [8] * FLEET_POINTS,
        fleet.controllers[0].cfg, 1, 4))
        if scheme == "control_plane"
        else (lambda: fleet.chunk(fleet._wl, fleet.carry, 4)))
    run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
