"""The port's popularity tracker and the servers' tracking against the
JAX reference, leaf for leaf, exactly.

Covers ``cms_update``/``cms_query``, the exact and the hashed candidate
merges (several winning lanes on one slot included: the last lane wins,
as the reference's scatter does), ``track`` and ``track_fused`` (one
tracker, and a leading axis of trackers against a JAX ``vmap``),
``report_and_reset`` (ties keep slot order, a stable sort) and
``server_step`` with ``track_popularity=True`` over chained windows.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import kernels as jkn  # noqa: E402
from repro.core import sketch as jsk  # noqa: E402
from repro.core.hashing import server_of_key as jax_server_of_key  # noqa: E402
from repro.core.types import empty_batch as jax_empty_batch  # noqa: E402
from repro.kvstore import server as jsrv  # noqa: E402
from torch_parity import assert_trees_equal  # noqa: E402

from repro_torch.core import sketch as tsk  # noqa: E402
from repro_torch.interop import from_numpy  # noqa: E402
from repro_torch.kvstore import server as tsrv  # noqa: E402

CPU = torch.device("cpu")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port(tree):
    return from_numpy(np_tree(tree), CPU)


def random_tracker(rng, width, k_cand, lead=(), universe=300):
    """A tracker with a nonzero sketch and a partly filled candidate
    table (estimates with ties)."""
    shp = lambda *s: lead + s
    kidx = rng.integers(0, universe, shp(k_cand)).astype(np.int32)
    kidx[rng.random(shp(k_cand)) < 0.3] = -1
    est = np.where(kidx >= 0, rng.integers(0, 6, shp(k_cand)), 0)
    return jsk.PopularityTracker(
        cms=jsk.CountMinSketch(jnp.asarray(
            rng.integers(0, 20, shp(jsk.CMS_DEPTH, width)), jnp.int32)),
        cand=jsk.CandidateSet(kidx=jnp.asarray(kidx),
                              est=jnp.asarray(est, jnp.int32)))


def batch(rng, b, universe=300, lead=()):
    kidx = rng.integers(0, universe, b).astype(np.int32)
    mask = rng.random(lead + (b,)) < 0.7
    return kidx, mask


@pytest.mark.parametrize("seed", range(4))
def test_cms_update_and_query(seed):
    rng = np.random.default_rng(seed)
    tr = random_tracker(rng, 64, 8)
    kidx, mask = batch(rng, 50)
    hk = jsk.hash128_u32(jnp.asarray(kidx))
    want = jsk.cms_update(tr.cms, hk, jnp.asarray(mask))
    got = tsk.cms_update(port(tr.cms), torch.from_numpy(
        np.asarray(hk).view(np.int32).copy()), torch.from_numpy(mask))
    assert_trees_equal(got, np_tree(want), "cms_update")
    want_q = np.asarray(jsk.cms_query(want, hk))
    got_q = tsk.cms_query(got, torch.from_numpy(
        np.asarray(hk).view(np.int32).copy()))
    np.testing.assert_array_equal(got_q.numpy(), want_q)


@pytest.mark.parametrize("k_cand,b", [(8, 64), (4, 40), (16, 16), (1, 9)])
def test_merge_candidates_hashed_shared_slots(k_cand, b):
    """More lanes than slots, tied estimates: several winning lanes claim
    one slot in a batch, and the last one wins."""
    rng = np.random.default_rng(k_cand * 100 + b)
    tr = random_tracker(rng, 64, k_cand)
    for _ in range(3):
        kidx = rng.integers(0, 40, b).astype(np.int32)
        est = rng.integers(0, 4, b).astype(np.int32)
        mask = rng.random(b) < 0.8
        want = jsk.merge_candidates_hashed(tr.cand, jnp.asarray(kidx),
                                           jnp.asarray(est),
                                           jnp.asarray(mask))
        got = tsk.merge_candidates_hashed(
            port(tr.cand), torch.from_numpy(kidx), torch.from_numpy(est),
            torch.from_numpy(mask))
        assert_trees_equal(got, np_tree(want), f"merge k={k_cand} b={b}")
        tr = tr._replace(cand=want)


def test_merge_candidates_hashed_leading_axis_matches_vmap():
    rng = np.random.default_rng(5)
    tr = random_tracker(rng, 64, 8, lead=(3,))
    kidx = rng.integers(0, 40, 64).astype(np.int32)
    est = rng.integers(0, 4, (3, 64)).astype(np.int32)
    mask = rng.random((3, 64)) < 0.8
    want = jax.vmap(jsk.merge_candidates_hashed, in_axes=(0, None, 0, 0))(
        tr.cand, jnp.asarray(kidx), jnp.asarray(est), jnp.asarray(mask))
    got = tsk.merge_candidates_hashed(port(tr.cand), torch.from_numpy(kidx),
                                      torch.from_numpy(est),
                                      torch.from_numpy(mask))
    assert_trees_equal(got, np_tree(want), "merge vmapped")


@pytest.mark.parametrize("exact", [False, True])
def test_track_matches_reference(exact):
    rng = np.random.default_rng(11 + exact)
    tr = random_tracker(rng, 64, 16)
    tr_t = port(tr)
    for step in range(4):
        kidx, mask = batch(rng, 48, universe=60)
        tr = jsk.track(tr, jnp.asarray(kidx), jnp.asarray(mask), exact=exact)
        tr_t = tsk.track(tr_t, torch.from_numpy(kidx),
                         torch.from_numpy(mask), exact=exact)
        assert_trees_equal(tr_t, np_tree(tr), f"track step {step}")


@pytest.mark.parametrize("n,b", [(None, 45), (None, 300), (4, 45), (4, 300)])
def test_track_fused_matches_reference(n, b):
    """Chained batches through the count-min op; with ``n`` trackers
    against the reference vmapped over them (shared keys, own masks)."""
    rng = np.random.default_rng(b + (n or 0))
    lead = () if n is None else (n,)
    tr = random_tracker(rng, 256, 32, lead=lead)
    tr_t = port(tr)
    fn = jsk.track_fused
    if n is not None:
        fn = jax.vmap(jsk.track_fused, in_axes=(0, None, 0))
    jkn.set_kernel_backend("ref")
    try:
        for step in range(3):
            kidx, mask = batch(rng, b, universe=b, lead=lead)
            tr = fn(tr, jnp.asarray(kidx), jnp.asarray(mask))
            tr_t = tsk.track_fused(tr_t, torch.from_numpy(kidx),
                                   torch.from_numpy(mask))
            assert_trees_equal(tr_t, np_tree(tr), f"n={n} step {step}")
    finally:
        jkn.set_kernel_backend(None)


@pytest.mark.parametrize("lead,k", [((), 8), ((), 40), ((5,), 8)])
def test_report_and_reset(lead, k):
    rng = np.random.default_rng(len(lead) + k)
    tr = random_tracker(rng, 64, 32, lead=lead)
    fn = lambda t: jsk.report_and_reset(t, k)
    if lead:
        fn = jax.vmap(fn)
    want = np_tree(fn(tr))
    got = tsk.report_and_reset(port(tr), k)
    for name, g, w in zip(("tracker", "top_k", "top_e"), got, want):
        assert_trees_equal(g, w, f"report {name}") if name == "tracker" \
            else np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


# ---------------------------------------------------------------------------
# server_step with tracking
# ---------------------------------------------------------------------------
def random_arrivals(rng, b, n_srv, num_keys, value_pad):
    """A window's lanes at the servers: reads, writes, fetches and
    corrections over a small key range (hot keys repeat)."""
    pk = jax_empty_batch(b, value_pad)
    kidx = rng.integers(0, num_keys, b).astype(np.int32)
    valid = rng.random(b) < 0.9
    op = rng.choice([0, 0, 0, 1, 4, 6], b).astype(np.int32)
    pk = pk._replace(
        op=jnp.asarray(np.where(valid, op, 7)), kidx=jnp.asarray(kidx),
        seq=jnp.asarray(rng.integers(0, 1 << 20, b), jnp.int32),
        client=jnp.asarray(rng.integers(0, 4, b), jnp.int32),
        vlen=jnp.asarray(rng.choice([64, 1024], b), jnp.int32),
        server=jax_server_of_key(jnp.asarray(kidx), n_srv),
        ts=jnp.asarray(rng.random(b) * 100, jnp.float32),
        valid=jnp.asarray(valid))
    to_server = valid & (rng.random(b) < 0.8)
    flag = rng.integers(0, 3, b).astype(np.int32)
    return pk, to_server, flag


@pytest.mark.parametrize("b", [40, 300])
def test_server_step_with_tracking_matches_reference(b):
    n_srv, num_keys, pad = 4, 100, 32
    kw = dict(num_servers=n_srv, queue_depth=16, cap_per_window=3,
              value_pad=pad, cms_width=128, k_candidates=16,
              track_popularity=True)
    jcfg, tcfg = jsrv.ServerConfig(**kw), tsrv.ServerConfig(**kw)
    rng = np.random.default_rng(b)
    st = jsrv.init_servers(jcfg, num_keys)
    st_t = port(st)
    jkn.set_kernel_backend("ref")
    try:
        for w in range(4):
            pk, to_srv, flag = random_arrivals(rng, b, n_srv, num_keys, pad)
            now = jnp.float32(100.0 * w)
            st, out = jsrv.server_step(st, jcfg, pk, jnp.asarray(to_srv),
                                       jnp.asarray(flag), now)
            st_t, out_t = tsrv.server_step(
                st_t, tcfg, port(pk), torch.from_numpy(to_srv),
                torch.from_numpy(flag), torch.tensor(100.0 * w))
            assert_trees_equal(st_t, np_tree(st), f"servers window {w}")
            assert_trees_equal(out_t, np_tree(out), f"out window {w}")
        assert int(np.asarray(st.tracker.cms.counts).sum()) > 0
        st, top_k, top_e = jsrv.server_reports_traced(st, 8)
        st_t, tk_t, te_t = tsrv.server_reports_traced(st_t, 8)
    finally:
        jkn.set_kernel_backend(None)
    assert_trees_equal(st_t, np_tree(st), "servers after report")
    np.testing.assert_array_equal(tk_t.numpy(), np.asarray(top_k))
    np.testing.assert_array_equal(te_t.numpy(), np.asarray(top_e))
    assert (np.asarray(top_k) >= 0).any()
    _, reports = tsrv.server_reports(st_t, 8)
    assert len(reports) == n_srv and reports[0][0].shape == (8,)
