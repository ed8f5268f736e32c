"""The servers' reply value bytes (``repro_torch.kernels.reply_values``).

``server_step`` makes every reply lane's value bytes in one
``reply_values`` call.  They must be the bytes of the plain expression it
replaced (``server_expression`` below, copied as ``server_step`` wrote
it), bit for bit, for any lane: values of length 0, exactly ``pad``, and
over it across 2 and 3 fragments; keys and versions near ``2**31`` and
negative; lanes that carry no value and lanes that are not live (the
expression does not mask those, so neither may the kernel).  Under
``torch.func.vmap`` the op's batching rule and its points op make one
call for all points, and a nested level (points x racks) folds into it.
On a card the CUDA kernel must equal the plain version at the paper's
shapes and at a ragged size, and a fleet launches it once a window.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as kn  # noqa: E402
from repro_torch.analysis.entry_points import _rack_cfg  # noqa: E402
from repro_torch.core.types import (  # noqa: E402
    OP_CRN_REQ, OP_F_REQ, OP_R_REQ, OP_W_REQ, empty_batch,
)
from repro_torch.kernels.reply_values import ops, ref  # noqa: E402
from repro_torch.kvstore import fleet as tfl  # noqa: E402
from repro_torch.kvstore import server as tsrv  # noqa: E402
from repro_torch.kvstore import workload as twl  # noqa: E402
from repro_torch.kvstore.simulator import make_server_config  # noqa: E402
from repro_torch.kvstore.store import synth_value  # noqa: E402

I32 = torch.int32
PAPER = dict(points=12, n=32, cap=10, f=1, pad=1438)


def server_expression(s_kidx, version, s_vlen, carries_val, f, pad):
    """``server_step``'s value bytes before the kernel, copied as it was
    (from ``frag_off`` down to ``val.reshape(n * cap * f, pad)``)."""
    n, cap = s_kidx.shape
    dev = s_kidx.device
    frag = torch.arange(f, dtype=I32, device=dev)[None, None, :]
    frag_off = frag * pad
    frag_vlen = torch.clamp(s_vlen[:, :, None] - frag_off, 0, pad)
    val = synth_value(s_kidx[:, :, None].expand(n, cap, f),
                      version[:, :, None].expand(n, cap, f), pad,
                      offset=frag_off.expand(n, cap, f))
    keep = ((torch.arange(pad, device=dev)[None, None, None, :]
             < frag_vlen[..., None]) & carries_val[:, :, None, None])
    val = torch.where(keep, val, 0).to(torch.uint8)
    return val.reshape(n * cap * f, pad)


def lanes(seed, n, cap, f, pad, lead=()):
    """Random lanes with the edges: vlen 0, pad, over pad, negative; keys
    and versions near 2**31 and negative; carries_val false."""
    rng = np.random.default_rng(seed)
    shape = tuple(lead) + (n, cap)
    edge = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1],
                    np.int64)
    k = rng.integers(-2**31, 2**31, shape)
    v = rng.integers(-2**31, 2**31, shape)
    k.flat[:edge.size] = edge[:k.size]
    v.flat[-edge.size:] = edge[-v.size:]
    vl = rng.integers(-3, f * pad + pad + 3, shape)
    sizes = np.array([0, 1, pad - 1, pad, pad + 1, 2 * pad, f * pad,
                      f * pad + 1, -1])
    vl.flat[:sizes.size] = sizes[:vl.size]
    c = rng.random(shape) < 0.75
    c.flat[0] = False
    return (torch.from_numpy(k.astype(np.int32)),
            torch.from_numpy(v.astype(np.int32)),
            torch.from_numpy(vl.astype(np.int32)), torch.from_numpy(c))


CASES = [(3, 5, 1, 16), (2, 7, 2, 17), (4, 3, 3, 8), (1, 1, 1, 1),
         (2, 10, 1, 1438), (3, 4, 2, 33)]


@pytest.mark.parametrize("n,cap,f,pad", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_reply_values_equal_server_expression(n, cap, f, pad, seed):
    """The dispatcher and ``ref`` on CPU tensors against the expression
    ``server_step`` replaced, bit for bit (the kernel's wrapper takes CUDA
    tensors only)."""
    args = lanes(seed, n, cap, f, pad)
    want = server_expression(*args, f, pad)
    assert want.dtype == torch.uint8 and want.shape == (n * cap * f, pad)
    for got in (kn.reply_values(*args, f, pad),
                ref.reply_values_ref(*args, f, pad)):
        assert got.dtype == torch.uint8
        assert torch.equal(got, want)
    if n * cap > 2:       # the edges reach both sides of the mask
        assert (want != 0).any() and (want == 0).any()


def per_point(fn, args, p):
    return torch.stack([fn(*(a[i] if a.dim() == 3 else a for a in args))
                        for i in range(p)])


@pytest.mark.parametrize("shared", [(), (1, 3), (0, 2, 3)])
def test_batching_rule_and_points_op(shared):
    """A fleet of 3 under vmap (inputs in ``shared`` the same for every
    point) against a loop over points: one dispatcher call, no vmap
    fallback."""
    p, n, cap, f, pad = 3, 4, 5, 2, 24
    args = list(lanes(7, n, cap, f, pad, lead=(p,)))
    for i in shared:
        args[i] = args[i][0]
    dims = tuple(None if i in shared else 0 for i in range(4))
    want = per_point(lambda *a: server_expression(*a, f, pad), args, p)
    kn.reset_launch_counts()
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = torch.func.vmap(
                lambda *a: kn.reply_values(*a, f, pad), in_dims=dims,
                randomness="error")(*args)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert torch.equal(got, want)
    assert kn.CALLS["reply_values"] == 1 and kn.LAUNCHES["reply_values"] == 0
    # the points op itself
    assert torch.equal(torch.ops.repro_torch.reply_values_points(
        args, p, [f, pad])[0], want)


def test_nested_points_fold():
    """Points x racks (2 x 2, a batched fabric's nesting): the inner
    level's points op folds the outer level into one call; an input the
    racks share and the points do not is expanded."""
    q, p, n, cap, f, pad = 2, 2, 3, 4, 3, 10
    k, v, vl, c = lanes(3, n, cap, f, pad, lead=(q, p))
    v_outer = v[:, 0]                        # [q, n, cap]: shared by racks
    c_all = c[0, 0]                          # [n, cap]: shared by both
    fn = lambda a, b, d: kn.reply_values(a, b, d, c_all, f, pad)  # noqa: E731
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = torch.func.vmap(torch.func.vmap(fn, in_dims=(0, None, 0)),
                                  in_dims=(0, 0, 0))(k, v_outer, vl)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    want = torch.stack([torch.stack([
        server_expression(k[i, j], v_outer[i], vl[i, j], c_all, f, pad)
        for j in range(p)]) for i in range(q)])
    assert got.shape == (q, p, n * cap * f, pad)
    assert torch.equal(got, want)


def _server_batch(cfg, width, seed, f):
    """Requests of every kind to both servers, values up to ``f`` frags."""
    rng = np.random.default_rng(seed)
    ops_ = np.array([OP_R_REQ, OP_W_REQ, OP_F_REQ, OP_CRN_REQ])
    pk = empty_batch(width, value_pad=cfg.value_pad, device="cpu")
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    return pk._replace(
        op=t(rng.choice(ops_, width)),
        kidx=t(rng.integers(0, 256, width)),
        seq=t(rng.integers(0, 1000, width)),
        client=t(rng.integers(0, 8, width)),
        vlen=t(rng.integers(0, f * cfg.value_pad + 8, width)),
        server=t(rng.integers(0, cfg.num_servers, width)),
        valid=torch.ones(width, dtype=torch.bool))


@pytest.mark.parametrize("max_frags", [1, 3])
def test_server_step_replies_unchanged(monkeypatch, max_frags):
    """``server_step`` on the lint's tiny rack (2 servers, ``value_pad``
    32): its replies and state, window after window with writes bumping
    versions, equal those of the plain expression in the kernel's place;
    one ``reply_values`` call a step."""
    cfg = dataclasses.replace(_rack_cfg(), max_frags=max_frags)
    scfg = make_server_config(cfg)
    on = torch.ones(24, dtype=torch.bool)
    flags = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2, 24).astype(np.int32))

    def run():
        st = tsrv.init_servers(scfg, num_keys=256, device="cpu")
        outs = []
        for w in range(4):
            st, out = tsrv.server_step(st, scfg, _server_batch(
                scfg, 24, w, max_frags), on, flags, torch.tensor(100.0 * w))
            outs.append(out)
        return st, outs

    kn.reset_launch_counts()
    st_k, outs_k = run()
    assert kn.CALLS["reply_values"] == 4
    monkeypatch.setattr(kn, "reply_values", server_expression)
    st_p, outs_p = run()
    for a, b in zip(outs_k, outs_p):
        for name, x, y in zip(a.replies._fields, a.replies, b.replies):
            assert torch.equal(x, y), name
        assert torch.equal(a.served_now, b.served_now)
    assert torch.equal(st_k.key_version, st_p.key_version)
    assert int(st_k.key_version.sum()) > 0          # versions moved
    assert any(bool(o.replies.val.any()) for o in outs_k)


def test_fleet_calls_once_a_window():
    """A 3-point fleet calls the op once a window, whatever P."""
    wl = twl.Workload(twl.WorkloadConfig(num_keys=256, offered_rps=1e5),
                      device="cpu")
    fleet = tfl.BatchedRackSimulator(_rack_cfg(), wl, n_points=3,
                                     device="cpu")
    kn.reset_launch_counts()
    fleet.run_windows(4)
    assert kn.CALLS["reply_values"] == 4


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: the kernel against ``ref`` exactly, serial and batched,
    at the paper's fleet shapes (12 x 32 servers x 10 lanes x 1 x 1,438
    bytes) and at ragged sizes (a flat size no multiple of 16, rows shorter
    than a thread's 16 bytes, 3 fragments, shared inputs); one launch a
    call."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    dev = torch.device("cuda", 0)
    cases = [dict(PAPER, shared=()), dict(points=3, n=5, cap=7, f=3, pad=37,
                                          shared=(2,)),
             dict(points=2, n=3, cap=3, f=2, pad=5, shared=(0, 3)),
             dict(points=1, n=1, cap=1, f=1, pad=1, shared=())]
    for seed, cs in enumerate(cases):
        p, n, cap, f, pad = (cs[k] for k in ("points", "n", "cap", "f",
                                             "pad"))
        args = list(lanes(seed, n, cap, f, pad, lead=(p,)))
        for i in cs["shared"]:
            args[i] = args[i][0]
        want = per_point(lambda *a: ref.reply_values_ref(*a, f, pad), args,
                         p)
        cu = [a.to(dev) for a in args]
        kn.reset_launch_counts()
        got = ops.reply_values(*cu, f, pad, p=p)
        one = ops.reply_values(*(a if a.dim() == 2 else a[0] for a in cu),
                               f, pad)
        torch.cuda.synchronize()
        assert kn.LAUNCHES["reply_values"] == 2
        assert torch.equal(got.cpu(), want), cs
        assert torch.equal(one.cpu(), want[0]), cs


@pytest.mark.cuda
def test_cuda_fleet_launches_once_a_window():
    """On the card, a 3-point fleet's windows (eager and graphed) launch
    the kernel once a window and equal the same fleet on the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    dev = torch.device("cuda", 0)
    wl = twl.Workload(twl.WorkloadConfig(num_keys=256, offered_rps=1e5),
                      device=dev)
    runs = {}
    for name, graphs, backend in (("eager", False, None),
                                  ("graphed", True, None),
                                  ("plain", False, "ref")):
        fleet = tfl.BatchedRackSimulator(_rack_cfg(), wl, n_points=3,
                                         device=dev, graphs=graphs)
        kn.set_kernel_backend(backend)
        try:
            fleet.run_windows(2)                  # warm-up (captures)
            kn.reset_launch_counts()
            fleet.run_windows(4)
            torch.cuda.synchronize()
        finally:
            kn.set_kernel_backend(None)
        want = 0 if backend == "ref" else 4
        assert kn.LAUNCHES["reply_values"] == want, name
        assert kn.CALLS["reply_values"] == 4, name
        runs[name] = [t.cpu() for t in torch.utils._pytree.tree_leaves(
            fleet.carry) if isinstance(t, torch.Tensor)]
    for name in ("eager", "graphed"):
        assert len(runs[name]) == len(runs["plain"])
        for a, b in zip(runs[name], runs["plain"]):
            assert torch.equal(a, b), name
