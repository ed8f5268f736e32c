"""The servers' FIFO enqueue (``repro_torch.kernels.server_enqueue``).

``server_step`` enqueues a window's arrivals in one ``server_enqueue``
call.  Its outputs must be those of the plain expression it replaced
(``server_expression`` below, copied as ``server_step`` wrote it), bit for
bit: lanes in lane order on their servers' rings, drops past a full queue,
rings that wrap, lanes to no server.  Under ``torch.func.vmap`` the op's
batching rule and its points op make one call for all points, and a
nested level (points x racks) folds into it.  ``server_step``'s whole
output is unchanged for every scheme.  On a card the CUDA kernel must
equal the plain version at the paper's shapes and on the edges, and every
path launches it once a window.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as kn  # noqa: E402
from repro_torch.analysis.entry_points import _rack_cfg  # noqa: E402
from repro_torch.core.scatter_free import unique_writer  # noqa: E402
from repro_torch.kernels.server_enqueue import ops, ref  # noqa: E402
from repro_torch.kvstore import fabric_sim as tfs  # noqa: E402
from repro_torch.kvstore import fleet as tfl  # noqa: E402
from repro_torch.kvstore import simulator as tsim  # noqa: E402
from repro_torch.kvstore import workload as twl  # noqa: E402

I32 = torch.int32
PAPER = dict(lanes=1344, n=32, q=64)     # 768 client + 320 reply + 256 fetch


def server_expression(server, to_server, fields, rings, qlen, rear):
    """``server_step``'s enqueue before the kernel, copied as it was (from
    ``srv = ...`` down to the rings' ``put``), with the dispatcher's
    signature."""
    n, q = rings[0].shape
    dev = rings[0].device
    ar = lambda m: torch.arange(m, dtype=I32, device=dev)  # noqa: E731
    srv = torch.where(to_server, server, 0).long()
    onehot = (srv[:, None] == ar(n)[None, :]) & to_server[:, None]
    oh = onehot.to(I32)
    prior = torch.cumsum(oh, dim=0, dtype=I32) - oh
    offset = torch.gather(prior, 1, srv[:, None])[:, 0]
    free = (q - qlen)[srv]
    accepted = to_server & (offset < free)
    dropped_now = torch.sum((to_server & ~accepted)[:, None] & onehot, dim=0,
                            dtype=I32)
    slot = (rear[srv] + offset) % q
    writer, written = unique_writer(srv * q + slot, accepted, n * q)
    put = lambda arr, val: torch.where(  # noqa: E731
        written, val[writer], arr.reshape(-1)).reshape(n, q)
    new_counts = torch.sum(onehot & accepted[:, None], dim=0, dtype=I32)
    return ([put(r, f) for r, f in zip(rings, fields)], qlen + new_counts,
            (rear + new_counts) % q, new_counts, dropped_now, accepted)


def flat(out):
    """A dispatcher-shaped output as one list of 13 tensors."""
    rings, *rest = out
    return [*rings, *rest]


def lanes(seed, b, n, q, lead=(), kind="random"):
    """``(server, to_server, fields, rings, qlen, rear)`` for ``b`` lanes
    and ``n`` servers of ``q`` slots, with ``lead`` axes.  ``random``: lanes
    to any server, a third to none (server -1 on some), queues from empty
    to full and ``rear`` anywhere; ``one``: every lane to server 0 (drops);
    ``wrap``: ``rear`` near ``q``; ``full``: every queue full; ``none``: no
    lane to any server."""
    rng = np.random.default_rng(seed)
    lb, ln = tuple(lead) + (b,), tuple(lead) + (n,)
    server = rng.integers(0, n, lb)
    to = rng.random(lb) < 0.67
    server[~to & (rng.random(lb) < 0.5)] = -1
    qlen = rng.integers(0, q + 1, ln)
    qlen.flat[:min(3, qlen.size)] = [0, q, q - 1][:min(3, qlen.size)]
    rear = rng.integers(0, q, ln)
    if kind == "one":
        server[:], to[:] = 0, True
        qlen[:] = rng.integers(0, q // 2 + 1, ln)
    elif kind == "wrap":
        rear[:] = q - 1 - rng.integers(0, 3, ln)
        qlen[:] = rng.integers(0, q // 4 + 1, ln)
    elif kind == "full":
        qlen[:] = q
    elif kind == "none":
        to[:] = False
    i32 = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    fields = [i32(rng.integers(-2**31, 2**31, lb)) for _ in range(7)]
    fields.append(torch.from_numpy(rng.standard_normal(lb).astype(
        np.float32)))
    shape = tuple(lead) + (n, q)
    rings = [i32(rng.integers(-2**31, 2**31, shape)) for _ in range(7)]
    rings.append(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)))
    return (i32(server), torch.from_numpy(to), fields, rings, i32(qlen),
            i32(rear))


def plain(*args):
    """``ref``, or, with no lanes (where it cannot index its empty lanes),
    what it means: rings and counts passed through."""
    if args[0].numel():
        return ref.server_enqueue_ref(*args)
    zero = torch.zeros_like(args[18])
    return (*args[10:18], args[18], args[19] % args[10].shape[1], zero,
            zero, torch.zeros(0, dtype=torch.bool))


def per_point(fn, args, p):
    """``fn`` once per point of ``args`` (a tensor whose rank is above its
    one-instance rank carries the point axis), stacked."""
    base = kn._SERVER_ENQUEUE_BASE
    outs = [fn(*(a[i] if a.dim() > r else a for a, r in zip(args, base)))
            for i in range(p)]
    return [torch.stack(x) for x in zip(*outs)]


def split(args):
    """Flat inputs as the dispatcher's ``(server, to_server, fields, rings,
    qlen, rear)``."""
    return (args[0], args[1], args[2:10], args[10:18], args[18], args[19])


@pytest.mark.parametrize("kind", ["random", "one", "wrap", "full", "none"])
@pytest.mark.parametrize("n,b", [(4, 37), (32, PAPER["lanes"])])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_version_equals_server_expression(n, b, kind, seed):
    """The dispatcher and ``ref`` on CPU tensors against the expression
    ``server_step`` replaced, bit for bit."""
    q = 8 if n == 4 else PAPER["q"]
    args = lanes(seed, b, n, q, kind=kind)
    want = flat(server_expression(*args))
    got_kn = flat(kn.server_enqueue(*args))
    flat_args = [args[0], args[1], *args[2], *args[3], args[4], args[5]]
    got_ref = list(ref.server_enqueue_ref(*flat_args))
    for got in (got_kn, got_ref):
        assert len(got) == len(want) == 13
        for k, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == w.dtype and torch.equal(g, w), k
    acc, drop = want[12], want[11]
    if kind in ("none", "full"):
        assert not acc.any()
    if kind == "one":
        assert acc.any() and drop[0] > 0
    if kind == "random":
        assert acc.any() and (args[1] & ~acc).any()


def test_cpu_dispatcher_launches_nothing():
    """On CPU tensors the dispatcher runs the plain version: one call, no
    launch; the wrapper refuses CPU tensors."""
    args = lanes(3, 20, 4, 8)
    kn.reset_launch_counts()
    kn.server_enqueue(*args)
    assert kn.CALLS["server_enqueue"] == 1
    assert kn.LAUNCHES["server_enqueue"] == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.server_enqueue(*args)


@pytest.mark.parametrize("shared", [(), (2, 9), (0, 1, 18, 19)])
def test_batching_rule_and_points_op(shared, monkeypatch):
    """A fleet of 3 under vmap (flat inputs in ``shared`` the same for
    every point) against a loop over points: one dispatcher call, no vmap
    fallback, each shared input handed over once (without the point
    axis); the points op itself gives the same."""
    p, b, n, q = 3, 29, 4, 8
    s, t, fields, rings, ql, rr = lanes(5, b, n, q, lead=(p,))
    args = [s, t, *fields, *rings, ql, rr]
    for i in shared:
        args[i] = args[i][0]
    dims = tuple(None if i in shared else 0 for i in range(20))
    want = per_point(lambda *a: flat(server_expression(*split(a))), args, p)
    seen = []
    real = kn._plain

    def recorded(fn, m, a, base):
        seen.append((m, [x.dim() for x in a]))
        return real(fn, m, a, base)
    monkeypatch.setattr(kn, "_plain", recorded)
    kn.reset_launch_counts()
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = torch.func.vmap(
                lambda *a: tuple(flat(kn.server_enqueue(*split(a)))),
                in_dims=dims, randomness="error")(*args)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), k
    assert kn.CALLS["server_enqueue"] == 1
    assert kn.LAUNCHES["server_enqueue"] == 0
    assert seen == [(p, [r + (i not in shared) for i, r in
                         enumerate(kn._SERVER_ENQUEUE_BASE)])]
    for k, (g, w) in enumerate(zip(
            torch.ops.repro_torch.server_enqueue_points(args, p, []), want)):
        assert torch.equal(g, w), k


def test_nested_points_fold(monkeypatch):
    """Points x racks (2 x 3, a batched fabric's nesting): the inner
    level's points op folds the outer level into one plain loop over all
    Q x P; inputs the racks share (the flags) are expanded, one shared by
    both (``rear``) stays."""
    q_, p, b, n, q = 2, 3, 17, 4, 8
    s, t, fields, rings, ql, rr = lanes(9, b, n, q, lead=(q_, p))
    flags = fields[5][:, 0]                     # [q_, b]: shared by racks
    rear = rr[0, 0]                             # [n]: shared by both
    loops = []
    real = kn._per_point

    def recorded(fn, m, args, batched):
        loops.append(m)
        return real(fn, m, args, batched)
    monkeypatch.setattr(kn, "_per_point", recorded)

    def fn(s_, t_, f0, f1, f2, f3, f4, fl, f6, f7, *rest):
        rings_, ql_ = rest[:8], rest[8]
        return tuple(flat(kn.server_enqueue(
            s_, t_, (f0, f1, f2, f3, f4, fl, f6, f7), rings_, ql_, rear)))

    outer = (0,) * 19
    inner = (0,) * 7 + (None,) + (0,) * 11
    args = [s, t, *fields[:5], flags, *fields[6:], *rings, ql]
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = torch.func.vmap(torch.func.vmap(fn, in_dims=inner),
                                  in_dims=outer)(*args)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert loops == [q_ * p]
    for i in range(q_):
        for j in range(p):
            f_ij = [x[i, j] for x in fields]
            f_ij[5] = flags[i]
            want = flat(server_expression(s[i, j], t[i, j], f_ij,
                                          [r[i, j] for r in rings],
                                          ql[i, j], rear))
            for k, (g, w) in enumerate(zip(got, want)):
                assert torch.equal(g[i, j], w), (i, j, k)


def _tiny(scheme, track=False):
    """The lint's tiny rack with queues of 4 (NetCache's values within its
    32-byte pad)."""
    kw = (dict(netcache_table=64, netcache_value_limit=16)
          if scheme == "netcache" else {})
    return _rack_cfg(scheme=scheme, track_popularity=track, server_queue=4,
                     **kw)


def _wl(device, rps=4e5):
    return twl.Workload(twl.WorkloadConfig(num_keys=256, offered_rps=rps),
                        device=device)


@pytest.mark.parametrize("scheme,track", [("orbitcache", False),
                                          ("orbitcache", True),
                                          ("netcache", False),
                                          ("nocache", False)])
def test_server_step_unchanged(monkeypatch, scheme, track):
    """A rack of each scheme (tracking on: the per-server read mask built
    from ``accepted``), driven past its servers' rate so queues fill and
    drop: every window's metrics and the whole carry, replies included,
    equal those of the plain expression in the kernel's place; one
    ``server_enqueue`` call a window."""
    cfg = _tiny(scheme, track)
    wl = _wl("cpu")

    def run():
        sim = tsim.RackSimulator(cfg, wl, device="cpu")
        out = [sim.run_windows(6), sim.run_windows(6)]
        return out, sim.carry

    kn.reset_launch_counts()
    got, carry_k = run()
    assert kn.CALLS["server_enqueue"] == 12
    monkeypatch.setattr(kn, "server_enqueue", server_expression)
    want, carry_p = run()
    for a, b_ in zip(got, want):
        for k in b_:
            np.testing.assert_array_equal(a[k], b_[k], err_msg=k)
    ka = torch.utils._pytree.tree_leaves(carry_k)
    kb = torch.utils._pytree.tree_leaves(carry_p)
    assert len(ka) == len(kb)
    for x, y in zip(ka, kb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert sum(int(np.asarray(w["dropped"]).sum()) for w in got) > 0
    assert sum(int(np.asarray(w["served"]).sum()) for w in got) > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


CARD_CASES = [
    # (points, lanes, n, q, kind, shared flat inputs)
    (1, PAPER["lanes"], 32, 64, "random", ()),
    (12, PAPER["lanes"], 32, 64, "random", ()),
    (12, PAPER["lanes"], 32, 64, "one", ()),
    (12, PAPER["lanes"], 32, 64, "wrap", ()),
    (12, PAPER["lanes"], 32, 64, "full", ()),
    (12, PAPER["lanes"], 32, 64, "none", ()),
    (3, PAPER["lanes"], 32, 64, "random", (0, 1, 7, 18)),
    (2, 1, 4, 64, "random", ()), (2, 31, 4, 64, "random", ()),
    (2, 33, 4, 8, "random", ()), (2, 513, 8, 64, "random", ()),
    (3, 2049, 16, 64, "random", ()), (2, 5000, 32, 64, "one", ()),
    (2, 700, 5, 3, "wrap", (19,)), (2, 0, 4, 8, "random", ()),
]


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: the kernel against ``ref`` exactly, at the paper's
    shapes at P = 1 and 12, every lane to one server, ``rear`` near ``q``,
    full queues, no lane to a server, lane counts no multiple of 32 or of
    the block (and past one pass of the block), no lanes, lanes to server
    -1, shared inputs; batched (one launch) and one point alone."""
    dev = _card()
    for seed, (p, b, n, q, kind, shared) in enumerate(CARD_CASES):
        s, t, fields, rings, ql, rr = lanes(seed, b, n, q, lead=(p,),
                                            kind=kind)
        args = [s, t, *fields, *rings, ql, rr]
        for i in shared:
            args[i] = args[i][0]
        want = per_point(plain, args, p)
        cu = [a.to(dev) for a in args]
        kn.reset_launch_counts()
        got = flat(ops.server_enqueue(*split(cu), p=p))
        one = flat(ops.server_enqueue(*split(
            [a if a.dim() == r else a[-1]
             for a, r in zip(cu, kn._SERVER_ENQUEUE_BASE)])))
        torch.cuda.synchronize()
        assert kn.LAUNCHES["server_enqueue"] == 2
        case = (p, b, n, q, kind, shared)
        for k, (g, o, w) in enumerate(zip(got, one, want)):
            assert g.dtype == w.dtype, (case, k)
            assert torch.equal(g.cpu(), w), (case, k)
            assert torch.equal(o.cpu(), w[-1]), (case, k)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["rack", "fleet", "fabric"])
def test_cuda_paths_launch_once_a_window(path):
    """On the card, a rack, a 3-point fleet and a batched fabric (3 points
    x 2 racks) launch the kernel once a window, graphed and eager, and
    equal the same path on the plain versions."""
    dev = _card()
    wl = _wl(dev)
    runs = {}
    for name, graphs, backend in (("eager", False, None),
                                  ("graphed", True, None),
                                  ("plain", False, "ref")):
        if path == "rack":
            sim = tsim.RackSimulator(_tiny("orbitcache"), wl, device=dev,
                                     graphs=graphs)
        elif path == "fleet":
            sim = tfl.BatchedRackSimulator(_tiny("orbitcache"), wl,
                                           n_points=3, device=dev,
                                           graphs=graphs)
        else:
            fcfg = tfs.FabricConfig(n_racks=2, spine_scheme="orbitcache",
                                    spine_cache_entries=8, spine_lanes=8,
                                    fwd_lanes=8)
            sim = tfl.BatchedFabricSimulator(_tiny("orbitcache"), fcfg, wl,
                                             n_points=3, device=dev,
                                             graphs=graphs)
        kn.set_kernel_backend(backend)
        try:
            sim.run_windows(2)                    # warm-up (captures)
            kn.reset_launch_counts()
            sim.run_windows(4)
            torch.cuda.synchronize()
        finally:
            kn.set_kernel_backend(None)
        want = 0 if backend == "ref" else 4
        assert kn.LAUNCHES["server_enqueue"] == want, name
        assert kn.CALLS["server_enqueue"] == 4, name
        runs[name] = [t.cpu() for t in torch.utils._pytree.tree_leaves(
            sim.carry) if isinstance(t, torch.Tensor)]
    for name in ("eager", "graphed"):
        assert len(runs[name]) == len(runs["plain"])
        for a, b in zip(runs[name], runs["plain"]):
            assert torch.equal(a, b), name
