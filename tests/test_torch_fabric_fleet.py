"""The port's batched fabric (``fleet.BatchedFabricSimulator``) against
serial port fabrics and against the reference's ``BatchedFabricSimulator``,
and the kernels' points ops under a second vmap level.

A batched fabric vmaps the fabric window over its points, and inside it
the racks again; each kernel must stay one op call per call site (one
launch on the card) for all points and racks, with no vmap fallback.
Point ``i`` must be the serial fabric of its seed and locality, leaf for
leaf, and the port's batched fabric the reference's on the reference's
draws (each point's racks and targets replayed), but for the latency
histograms' ``hist_close``.

Small shapes: C = 16, 2 servers, a 64-lane batch, 2 subrounds, 2 racks.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import kernels as jkn  # noqa: E402
from repro.kvstore import fabric_sim as jfs  # noqa: E402
from repro.kvstore import fleet as jfl  # noqa: E402
from repro.kvstore import simulator as jsim  # noqa: E402
from repro.kvstore import workload as jwl  # noqa: E402
from test_torch_fabric import (  # noqa: E402
    RACK, TOL, WORKLOAD, fabric_cfg, replayed_draws, workload,
)
from test_torch_subround import case, to_port  # noqa: E402
from torch_parity import assert_trees_equal  # noqa: E402

from repro_torch import kernels as kn  # noqa: E402
from repro_torch.interop import fabric_carry_from_numpy, to_numpy  # noqa
from repro_torch.kvstore import fabric_sim as tfs  # noqa: E402
from repro_torch.kvstore import fleet as tfl  # noqa: E402
from repro_torch.kvstore import simulator as tsim  # noqa: E402

CPU = torch.device("cpu")
FRACS = (1.0, 0.5)


def small(spine, **kw):
    return tfs.FabricConfig(**fabric_cfg(spine, n_racks=2, **kw))


@pytest.mark.parametrize("scheme", ["orbitcache", "netcache", "nocache"])
def test_points_match_serial_fabrics_without_fallback(scheme):
    """Two points (locality 1.0 and 0.5, the same scheme at both tiers):
    the preload with 2 warm windows, 4 windows and a period of 3, each
    point equal to the serial fabric of its seed (``cfg.seed + 1000 i``)
    and locality in every trace and carry leaf; no op falls back to
    vmap's per-point loop (its warning on and made an error)."""
    cfg = tsim.RackConfig(**RACK, scheme=scheme, track_popularity=True,
                          netcache_entries=40, netcache_value_limit=64)
    fcfg = small(scheme)
    wl = workload(write_ratio=0.1)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            bf = tfl.BatchedFabricSimulator(cfg, fcfg, wl, local_fracs=FRACS,
                                            device="cpu")
            bf.preload(warm_windows=2)
            got = [bf.run_windows(4), bf.run_periods(1, 3)]
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert got[0]["rack_tx"].shape == (2, 4, 2)
    assert got[0]["spine_remote"].shape == (2, 4)
    for i, frac in enumerate(FRACS):
        s = tfs.FabricSimulator(dataclasses.replace(cfg, seed=1000 * i),
                                fcfg, wl, device="cpu")
        s.set_local_frac(frac)
        s.preload(warm_windows=2)
        want = [s.run_windows(4), s.run_periods(1, 3)]
        for g, w in zip(got, want):
            for k, v in w.items():
                assert g[k].dtype == v.dtype, k
                np.testing.assert_array_equal(g[k][i], v,
                                              err_msg=f"point {i}: {k}")
        assert_trees_equal(tsim.tree_take(bf.carry, i), to_numpy(s.carry),
                           f"point {i}")
        assert [c.active_size for c in bf.controllers[i]] == \
            [c.active_size for c in s.controllers]
        assert bf.spine_controllers[i].active_size == \
            s.spine_controller.active_size
    assert got[0]["spine_remote"][0].sum() == 0
    assert got[0]["spine_remote"][1].sum() > 0


def test_batched_fabric_matches_jax():
    """The reference's ``BatchedFabricSimulator`` (OrbitCache at both
    tiers, tracking on, localities 0.9 and 0.5, offered 0.8 and 0.6 M rps),
    its stacked preloaded carry carried across and every point's draws
    replayed: two periods of 3 windows equal in every trace ``[N, n,
    ...]``, carry leaf and active size."""
    rack = dict(RACK, scheme="orbitcache", track_popularity=True)
    fkw = fabric_cfg("orbitcache", n_racks=2)
    fracs, loads = [0.9, 0.5], [0.8e6, 0.6e6]
    jkn.set_kernel_backend("ref")
    try:
        ref = jfl.BatchedFabricSimulator(
            jsim.RackConfig(**rack), jfs.FabricConfig(**fkw),
            jwl.Workload(jwl.WorkloadConfig(**WORKLOAD)),
            local_fracs=fracs, offered_rps=loads)
        ref.preload(warm_windows=0)
        draws = [replayed_draws(jax.tree.map(lambda x, i=i: x[i], ref.carry),
                                rack, jfs.FabricConfig(**fkw), 6)
                 for i in range(2)]
        port = tfl.BatchedFabricSimulator(
            tsim.RackConfig(**rack), tfs.FabricConfig(**fkw), workload(),
            local_fracs=fracs, offered_rps=loads, device="cpu", draws=draws)
        port.preload(warm_windows=0)
        carry = jax.tree.map(np.asarray, ref.carry)
        assert_trees_equal(port.carry, carry._replace(fabric_rng=()),
                           "preload", tolerate=TOL)
        port.carry = fabric_carry_from_numpy(
            carry, tfs.BatchedFabricDraws(draws), CPU)
        m_ref = ref.run_periods(2, 3)
    finally:
        jkn.set_kernel_backend(None)
    m_port = port.run_periods(2, 3)
    assert set(m_port) == set(m_ref)
    for k, v in m_ref.items():
        v = np.asarray(v)
        assert m_port[k].dtype == v.dtype, k
        np.testing.assert_array_equal(m_port[k], v, err_msg=k)
    assert_trees_equal(port.carry, ref.carry._replace(fabric_rng=()),
                       "carry", tolerate=TOL)
    for cs_p, cs_r in zip(port.controllers, ref._controllers):
        assert [c.active_size for c in cs_p] == [c.active_size for c in cs_r]
    assert [s.active_size for s in port.spine_controllers] == \
        [s.active_size for s in ref._spine_controllers]
    assert m_port["spine_served"].sum() > 0


OPS = {"subround": "_subround_op", "cms": "_cms_op",
       "hot_gather": "_hot_gather_op",
       "server_enqueue": "_server_enqueue_op"}


@pytest.mark.parametrize("n_points", [1, 3])
def test_one_op_call_per_call_site_nested(n_points, monkeypatch):
    """A batched fabric window calls the subround op once per subround
    for all racks and once for all spines, the count-min and enqueue ops
    once; a
    period boundary the hot_gather op three times for the racks and three
    for the spines.  Whatever P; each points op runs once for all P x R
    points."""
    calls = dict.fromkeys(OPS, 0)
    for name, attr in OPS.items():
        def counted(*a, _real=getattr(kn, attr), _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(kn, attr, counted)
    per_point = []
    real_per_point = kn._per_point

    def recorded(fn, p, args, batched):
        per_point.append(p)
        return real_per_point(fn, p, args, batched)
    monkeypatch.setattr(kn, "_per_point", recorded)

    def count(fn):
        calls.update(dict.fromkeys(OPS, 0))
        per_point.clear()
        fn()
        return dict(calls)

    cfg = tsim.RackConfig(**RACK, track_popularity=True)
    bf = tfl.BatchedFabricSimulator(cfg, small("orbitcache"), workload(),
                                    n_points=n_points, device="cpu")
    bf.preload(warm_windows=0)
    s = cfg.subrounds
    assert count(lambda: bf.run_windows(2)) == dict(
        subround=2 * 2 * s, cms=2, hot_gather=0, server_enqueue=2)
    # per window: S spine calls (P points), S rack calls, one count-min,
    # one server_enqueue and one reply_values call (P x R points)
    assert sorted(per_point) == sorted(
        ([n_points] * s + [2 * n_points] * (s + 3)) * 2)
    assert count(lambda: bf.run_periods(1, 2)) == dict(
        subround=2 * 2 * s, cms=2, hot_gather=6, server_enqueue=2)


def nested(fn, q, p, args, dims):
    """``fn`` under two vmap levels: ``dims[k]`` is ``(outer, inner)``,
    each 0 or None (input k batched over that level or shared)."""
    def inner(*xs):
        return torch.func.vmap(fn, in_dims=tuple(d[1] for d in dims))(*xs)
    return torch.func.vmap(inner, in_dims=tuple(d[0] for d in dims))(*args)


def point(args, dims, i, j):
    """Input values of outer point ``i``, inner point ``j``."""
    out = []
    for a, (do, di) in zip(args, dims):
        a = a[i] if do == 0 else a
        out.append(a[j] if di == 0 else a)
    return out


def stacked(make, q, p, dims):
    """Inputs for a nested call: ``make(seed)`` per (outer, inner) point,
    stacked where batched (a shared level takes point 0's)."""
    per = [[make(10 * i + j) for j in range(p)] for i in range(q)]
    out = []
    for k, (do, di) in enumerate(dims):
        def lvl(i):
            row = [per[i][j][k] for j in range(p)]
            return torch.stack(row) if di == 0 else row[0]
        out.append(torch.stack([lvl(i) for i in range(q)]) if do == 0
                   else lvl(0))
    return out


SHARINGS = {"all": (0, 0), "over_racks": (0, None),
            "over_points": (None, 0), "both": (None, None)}


@pytest.mark.parametrize("sharing", list(SHARINGS))
def test_points_ops_fold_a_second_vmap_level(sharing, monkeypatch):
    """Each kernel's op under two vmap levels (Q = 2 points of P = 3
    racks), an input batched at both levels, shared over the racks but not
    the points (expanded), shared over the points but not the racks, or
    shared by both: equal to the plain version per (point, rack), and the
    points op's plain loop runs once for all Q x P."""
    q, p = 2, 3
    mode = SHARINGS[sharing]
    loops = []
    real = kn._per_point

    def recorded(fn, n, args, batched):
        loops.append(n)
        return real(fn, n, args, batched)
    monkeypatch.setattr(kn, "_per_point", recorded)

    from repro_torch.kernels.cms.ops import rows_for, tile_for
    from repro_torch.kernels.cms.ref import cms_update_query_fast
    from repro_torch.kernels.hot_gather.ref import hot_gather_ref
    from repro_torch.kernels.subround.ref import subround_ref

    # subround: the lanes batched at both levels, the tables per `mode`
    b, c, s_, f, j = 24, 8, 4, 1, 4
    sr_dims = [(0, 0)] * 12 + [mode] * 18 + [(0, 0)]

    args = stacked(lambda seed: to_port(case(seed, b, c, s_, f)[1]), q, p,
                   sr_dims)
    got = nested(lambda *a: tuple(kn.subround(*a, queue_size=s_,
                                              max_frags=f, max_serves=j)),
                 q, p, args, sr_dims)
    for i in range(q):
        for k in range(p):
            want = subround_ref(*point(args, sr_dims, i, k), queue_size=s_,
                                max_frags=f, max_serves=j)
            for g, w in zip(got, want):
                assert torch.equal(g[i, k], w)
    assert loops == [q * p]

    # count-min: the key hashes per `mode`, sketches at both levels
    loops.clear()
    cms_dims = [mode, (0, 0), (0, 0)]

    def cms_make(seed):
        r = np.random.default_rng(seed)
        return [torch.as_tensor(r.integers(-2**31, 2**31, (40, 4),
                                           dtype=np.int64).astype(np.int32)),
                torch.as_tensor(r.random((3, 40)) < 0.5),
                torch.as_tensor(r.integers(0, 9, (3, 5, 32)).astype(
                    np.int32))]
    args = stacked(cms_make, q, p, cms_dims)
    got = nested(lambda h, m, cnt: kn.cms_update_query(h, m, cnt, 16), q, p,
                 args, cms_dims)
    for i in range(q):
        for k in range(p):
            h, m, cnt = point(args, cms_dims, i, k)
            want = cms_update_query_fast(rows_for(h, 32), m.to(torch.int32),
                                         cnt, block_b=tile_for(40, 16))
            for g, w in zip(got, want):
                assert torch.equal(g[i, k], w)
    assert loops == [q * p]

    # hot_gather: the rows per `mode`, ids and hot ids at both levels
    loops.clear()
    hg_dims = [(0, 0), (0, 0), mode]

    def hg_make(seed):
        r = np.random.default_rng(seed)
        return [torch.as_tensor(r.integers(0, 12, 30).astype(np.int32)),
                torch.as_tensor(r.permutation(16)[:10].astype(np.int32)),
                torch.as_tensor(r.integers(0, 100, (10, 2)).astype(
                    np.int32))]
    args = stacked(hg_make, q, p, hg_dims)
    got = nested(kn.hot_gather, q, p, args, hg_dims)
    for i in range(q):
        for k in range(p):
            want = hot_gather_ref(*point(args, hg_dims, i, k))
            for g, w in zip(got, want):
                assert torch.equal(g[i, k], w)
    assert loops == [q * p]


def test_batched_fabric_argument_rules():
    cfg = tsim.RackConfig(**RACK)
    fcfg = small("nocache")
    wl = workload()
    with pytest.raises(ValueError, match="sweep points"):
        tfl.BatchedFabricSimulator(cfg, fcfg, wl, local_fracs=[1.0, 0.5],
                                   seeds=[1, 2, 3], device="cpu")
    with pytest.raises(ValueError, match="sweep points"):
        tfl.BatchedFabricSimulator(cfg, fcfg, wl, local_fracs=[1.0, 0.5],
                                   offered_rps=[1e5, 2e5, 3e5],
                                   device="cpu")
    bf = tfl.BatchedFabricSimulator(cfg, fcfg, wl, n_points=3,
                                    offered_rps=2e5, device="cpu")
    bf.preload()
    with pytest.raises(RuntimeError, match="preload once"):
        bf.preload()
    seeds = [[s.gen.initial_seed() for s in d.racks.sources]
             for d in bf.carry.draws.sources]
    assert seeds == [[cfg.seed + 1000 * i + r for r in range(2)]
                     for i in range(3)]
    np.testing.assert_array_equal(
        to_numpy(bf.carry.racks.offered),
        np.full((3, 2), np.float32(2e5 * 100 * 1e-6)))


def test_batched_fabric_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfl.BatchedFabricSimulator(tsim.RackConfig(**RACK), small("nocache"),
                                   workload(), n_points=2)


@pytest.mark.cuda
def test_nested_batched_launches_equal_plain():
    """On the card: the three kernels under two vmap levels (2 points of 3
    racks, tables shared over the racks and expanded) launch once each and
    equal the plain version per (point, rack); a batched fabric window
    graphed equals its eager chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.subround.ref import subround_ref

    dev = torch.device("cuda")
    q, p, (b, c, s_, f, j) = 2, 3, (24, 8, 4, 1, 4)
    dims = [(0, 0)] * 12 + [(0, None)] * 18 + [(0, 0)]
    args = [a.to(dev) for a in stacked(
        lambda seed: to_port(case(seed, b, c, s_, f)[1]), q, p, dims)]
    kn.reset_launch_counts()
    got = nested(lambda *a: tuple(kn.subround(*a, queue_size=s_,
                                              max_frags=f, max_serves=j)),
                 q, p, args, dims)
    assert kn.LAUNCHES["subround"] == 1
    for i in range(q):
        for k in range(p):
            want = subround_ref(*point(args, dims, i, k), queue_size=s_,
                                max_frags=f, max_serves=j)
            for g, w in zip(got, want):
                assert torch.equal(g[i, k], w)

    cfg = tsim.RackConfig(**RACK, track_popularity=True)
    from repro_torch.kvstore import workload as twl
    wl = twl.Workload(twl.WorkloadConfig(**WORKLOAD), device=dev)
    bf = tfl.BatchedFabricSimulator(cfg, small("orbitcache"), wl,
                                    local_fracs=FRACS)
    bf.preload()
    start = tsim.tree_map(torch.clone, bf.carry)
    state = bf.carry.draws.get_state()
    runs = []
    for graphs in (True, False):
        bf.carry = tsim.tree_map(torch.clone, start)
        bf.carry.draws.set_state(state)
        bf.chunk.graphs = graphs
        kn.reset_launch_counts()
        out = [bf.run_windows(4), bf.run_periods(1, 2)]
        runs.append((out, to_numpy(bf.carry), dict(kn.LAUNCHES)))
    (g, cg, lg), (e, ce, le) = runs
    for a, b_ in zip(g, e):
        for k in a:
            np.testing.assert_array_equal(a[k], b_[k], err_msg=k)
    assert_trees_equal(cg, ce, "graphed vs eager")
    assert lg == le == dict(subround=6 * 2 * cfg.subrounds, cms=6,
                            hot_gather=6, orbit_match=0, reply_values=6,
                            server_enqueue=6)
