"""The port's switch step and composed modules against the reference.

The six scenarios of ``tests/test_switch.py`` (paper §3.3 Fig. 4, §3.7)
through the port's ``core.switch.switch_step``, each step held equal to
the reference's ``switch_step`` on the same packets, leaf for leaf; then
``lookup``, ``state_table``, ``orbit`` and their controller-side writes
against the reference on seeded switch states.  Coherence is checked by
content: orbit lines carry real value bytes."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CacheController as JController
from repro.core import ControllerConfig as JConfig
from repro.core import empty_batch as j_empty
from repro.core import init_switch_state as j_init
from repro.core import lookup as jlk
from repro.core import orbit as job
from repro.core import state_table as jst
from repro.core import switch as jswm
from repro.core.hashing import hash128_u32_np
from repro.kvstore.store import synth_value as j_synth
from repro_torch.core import lookup as lk
from repro_torch.core import orbit as ob
from repro_torch.core import state_table as stt
from repro_torch.core.controller import CacheController, ControllerConfig
from repro_torch.core.switch import (
    OP_F_REP, OP_R_REQ, OP_W_REP, OP_W_REQ, ROUTE_CLIENT, ROUTE_DROP,
    ROUTE_SERVER, switch_step,
)
from repro_torch.core.types import init_switch_state
from repro_torch.interop import from_numpy
from torch_parity import assert_trees_equal

PAD = 64
I32 = torch.int32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def values(keys, version=0):
    k = jnp.asarray(keys, jnp.int32)
    return np.asarray(j_synth(k, jnp.full_like(k, version), PAD))


def make_pk(ops, kidxs, flags=None, vals=None, vlens=None, seqs=None):
    """A reference packet batch as numpy (8 lanes at least)."""
    n = len(ops)
    pk = _np(j_empty(max(n, 8), value_pad=PAD))
    k = np.asarray(kidxs, np.int32)
    upd = dict(op=np.asarray(ops, np.int32), kidx=k, hkey=hash128_u32_np(k),
               client=np.arange(n, dtype=np.int32),
               seq=np.asarray(seqs if seqs else np.arange(n), np.int32),
               valid=np.ones(n, bool))
    for f, v in (("flag", flags), ("val", vals), ("vlen", vlens)):
        if v is not None:
            upd[f] = np.asarray(v, getattr(pk, f).dtype)
    fields = {}
    for f, v in upd.items():
        a = getattr(pk, f).copy()
        a[:n] = v
        fields[f] = a
    return pk._replace(**fields)


@functools.lru_cache(maxsize=None)
def _ref_step(max_serves):
    return jax.jit(lambda sw, pk, b: jswm.switch_step(sw, pk, b, max_serves))


class Twin:
    """One switch in each package, stepped on the same packets."""

    def __init__(self, keys=(0, 1, 2, 3), entries=8):
        self.ref = j_init(entries, queue_size=4, value_pad=PAD)
        self.sw = init_switch_state(entries, queue_size=4, value_pad=PAD,
                                    device="cpu")
        self.jctrl = JController(JConfig(active_size=entries))
        self.ctrl = CacheController(ControllerConfig(active_size=entries))
        keys = np.asarray(keys, np.int32)
        self.ref, fetches = self.jctrl.preload(self.ref, keys)
        self.sw, port_fetches = self.ctrl.preload(self.sw, keys)
        assert port_fetches == fetches
        self.check("preload")
        ks = [k for k, _ in fetches]
        n = len(ks)
        self.step(make_pk([OP_F_REP] * n, ks, flags=[1] * n,
                          vals=values(ks), vlens=[32] * n, seqs=[0] * n),
                  100)

    def check(self, label, out=None, ref_out=None):
        assert_trees_equal(self.sw, _np(self.ref), f"{label} state")
        if out is not None:
            assert_trees_equal(out, _np(ref_out), f"{label} output")

    def step(self, pk, budget, label="step"):
        self.ref, ref_out = _ref_step(4)(self.ref, _j(pk), jnp.int32(budget))
        self.sw, out = switch_step(self.sw, from_numpy(pk, "cpu"),
                                   torch.tensor(budget, dtype=I32), 4)
        self.check(label, out, ref_out)
        return out


def test_hit_enqueues_and_orbit_serves_with_bytes():
    tw = Twin()
    out = tw.step(make_pk([OP_R_REQ] * 3, [0, 0, 1]), 100)
    assert int(out.stats.n_hit) == 3 and int(out.stats.n_served) == 3
    assert out.route[:3].tolist() == [ROUTE_DROP] * 3
    np.testing.assert_array_equal(tw.sw.orbit.val[0].numpy(), values([0])[0])
    assert int(out.grid.kidx[0]) == 0


def test_miss_routes_to_server():
    tw = Twin()
    out = tw.step(make_pk([OP_R_REQ], [77]), 100)
    assert int(out.route[0]) == ROUTE_SERVER and int(out.stats.n_hit) == 0


def test_write_invalidates_and_reply_revalidates_with_new_bytes():
    tw = Twin()
    out = tw.step(make_pk([OP_W_REQ], [2]), 100)
    assert int(out.flag[0]) == 1 and int(out.route[0]) == ROUTE_SERVER
    cidx = 2     # preload order: keys 0..3 -> entries 0..3
    assert not bool(tw.sw.state.valid[cidx])
    assert not bool(tw.sw.orbit.live[cidx])          # stale line dropped
    out = tw.step(make_pk([OP_R_REQ], [2]), 100)
    assert int(out.route[0]) == ROUTE_SERVER and int(out.stats.n_served) == 0
    newv = values([2], version=1)
    out = tw.step(make_pk([OP_W_REP], [2], flags=[1], vals=newv, vlens=[32]),
                  100)
    assert int(out.route[0]) == ROUTE_CLIENT      # clone: client replied
    assert bool(tw.sw.state.valid[cidx]) and bool(tw.sw.orbit.live[cidx])
    np.testing.assert_array_equal(tw.sw.orbit.val[cidx].numpy(), newv[0])
    out = tw.step(make_pk([OP_R_REQ], [2]), 100)
    assert int(out.stats.n_served) == 1


def test_one_line_serves_many_requests_cloning():
    tw = Twin()
    out = tw.step(make_pk([OP_R_REQ] * 4, [3, 3, 3, 3]), 100)
    assert int(out.stats.n_served) == 4
    assert bool(tw.sw.orbit.live[3])


def test_recirculation_budget_limits_serving():
    tw = Twin()
    out = tw.step(make_pk([OP_R_REQ] * 4, [0, 0, 0, 0]), 4)
    assert int(out.stats.n_served) == 1 and int(tw.sw.reqtab.qlen[0]) == 3
    out = tw.step(_np(j_empty(8, PAD)), 100)
    assert int(out.stats.n_served) == 3


def test_eviction_inherits_cacheidx_and_collision_resolution_path():
    tw = Twin()
    tw.step(make_pk([OP_R_REQ] * 6, [1, 2, 3, 1, 2, 3]), 100)
    tw.step(make_pk([OP_R_REQ], [0]), 0)
    assert int(tw.sw.reqtab.qlen[0]) == 1
    reports = [(np.asarray([50]), np.asarray([1000]))]
    tw.ctrl.active_size = tw.jctrl.active_size = 4
    tw.sw, info = tw.ctrl.update(tw.sw, reports)
    tw.ref, jinfo = tw.jctrl.update(tw.ref, reports)
    tw.check("update")
    assert info.fetches == jinfo.fetches
    assert 0 in info.evicted.tolist() and 50 in info.inserted.tolist()
    assert [c for k, c in info.fetches if k == 50] == [0]   # inherited
    out = tw.step(make_pk([OP_F_REP], [50], flags=[1], vals=values([50]),
                          vlens=[32]), 100)
    assert int(out.stats.n_served) == 1
    assert int(out.grid.kidx[0]) == 50     # the client sees 50 != 0


# ---------------------------------------------------------------------------
# the composed modules against the reference on seeded switch states
# ---------------------------------------------------------------------------
def random_switch(rng, c=16, s=4, f=2, pad=16, n_keys=24):
    """A reference SwitchState (numpy) with every table in a random
    state: occupied and free entries, two entries sharing a hash, stale
    and current lines, partial fragment sets, filled queues."""
    sw = _np(j_init(c, s, value_pad=pad, max_frags=f))
    kidx = rng.permutation(n_keys)[:c].astype(np.int32)
    kidx[c - 1] = kidx[1]                        # a repeated hash
    occ = rng.random(c) < 0.75
    version = rng.integers(0, 3, c).astype(np.int32)
    line_version = np.repeat(version, f) - (rng.random(c * f) < 0.2)
    qlen = rng.integers(0, s + 1, c).astype(np.int32)
    front = rng.integers(0, s, c).astype(np.int32)
    return sw._replace(
        lookup=sw.lookup._replace(
            hkeys=np.where(occ[:, None], hash128_u32_np(kidx), 0
                           ).astype(np.uint32),
            occupied=occ, kidx=np.where(occ, kidx, -1).astype(np.int32)),
        state=sw.state._replace(valid=rng.random(c) < 0.8, version=version),
        reqtab=sw.reqtab._replace(
            client=rng.integers(0, 4, c * s).astype(np.int32),
            seq=rng.integers(0, 100, c * s).astype(np.int32),
            ts=rng.random(c * s, dtype=np.float32),
            kidx=rng.integers(0, n_keys, c * s).astype(np.int32),
            qlen=qlen, front=front,
            rear=((front + qlen) % s).astype(np.int32)),
        orbit=sw.orbit._replace(
            live=rng.random(c * f) < 0.7,
            kidx=np.repeat(kidx, f),
            version=line_version.astype(np.int32),
            vlen=rng.integers(0, 40, c * f).astype(np.int32),
            val=rng.integers(0, 256, (c * f, pad)).astype(np.uint8),
            frags=rng.integers(1, f + 1, c).astype(np.int32)))


SEEDS = range(4)


@pytest.mark.parametrize("seed", SEEDS)
def test_lookup_install_evict_match_reference(seed):
    rng = np.random.default_rng(seed)
    sw = random_switch(rng)
    c = sw.lookup.occupied.shape[0]
    table, jtable = from_numpy(sw.lookup, "cpu"), _j(sw.lookup)
    keys = rng.integers(0, 30, 40).astype(np.int32)
    hk = hash128_u32_np(keys)
    assert_trees_equal(lk.lookup(table, from_numpy(hk, "cpu", "hkey")),
                       _np(jlk.lookup(jtable, jnp.asarray(hk))), "lookup")
    # distinct entries, with -1, -c and out-of-range ones (the reference
    # counts a negative index from the end and drops one outside)
    cidx = np.asarray([3, -1, c, 0, -c, c + 5, -c - 2], np.int32)
    new = rng.integers(100, 200, cidx.shape[0]).astype(np.int32)
    nhk = hash128_u32_np(new)
    assert_trees_equal(
        lk.install(table, _t(cidx), from_numpy(nhk, "cpu", "hkey"), _t(new)),
        _np(jlk.install(jtable, jnp.asarray(cidx), jnp.asarray(nhk),
                        jnp.asarray(new))), "install")
    assert_trees_equal(lk.evict(table, _t(cidx)),
                       _np(jlk.evict(jtable, jnp.asarray(cidx))), "evict")


@pytest.mark.parametrize("seed", SEEDS)
def test_state_table_matches_reference(seed):
    rng = np.random.default_rng(10 + seed)
    st = random_switch(rng).state
    c = st.valid.shape[0]
    cidx = rng.integers(0, c, 48).astype(np.int32)    # repeats included
    inv, val = rng.random(48) < 0.4, rng.random(48) < 0.4
    port, ref = from_numpy(st, "cpu"), _j(st)
    a, b, i, v = _t(cidx), jnp.asarray(cidx), _t(inv), jnp.asarray(val)
    assert_trees_equal(stt.invalidate(port, a, i),
                       _np(jst.invalidate(ref, b, jnp.asarray(inv))),
                       "invalidate")
    assert_trees_equal(stt.validate(port, a, _t(val)),
                       _np(jst.validate(ref, b, v)), "validate")
    assert_trees_equal(stt.apply_batch(port, a, i, _t(val)),
                       _np(jst.apply_batch(ref, b, jnp.asarray(inv), v)),
                       "apply_batch")


@pytest.mark.parametrize("seed", SEEDS)
def test_orbit_pass_matches_reference(seed):
    rng = np.random.default_rng(20 + seed)
    sw = random_switch(rng)
    port, ref = from_numpy(sw, "cpu"), _j(sw)
    assert_trees_equal(ob.refresh_liveness(port),
                       _np(job.refresh_liveness(ref)), "refresh_liveness")
    for budget in (0, 5, 37, 1000):
        b = torch.tensor(budget, dtype=I32)
        assert_trees_equal(ob.pass_budget(port.orbit, b),
                           _np(job.pass_budget(ref.orbit, jnp.int32(budget))),
                           f"pass_budget {budget}")
        for j in (1, 4, 6):
            assert_trees_equal(
                ob.orbit_pass(port, b, j),
                _np(job.orbit_pass(ref, jnp.int32(budget), j)),
                f"orbit_pass budget={budget} J={j}")


@pytest.mark.parametrize("seed", SEEDS)
def test_install_and_evict_lines_match_reference(seed):
    rng = np.random.default_rng(30 + seed)
    orbit = random_switch(rng).orbit
    c, f = orbit.frags.shape[0], orbit.live.shape[0] // orbit.frags.shape[0]
    b = 32
    # repeated lines and entries: the last packet wins in both packages
    cidx = rng.integers(0, c, b).astype(np.int32)
    lanes = dict(mask=rng.random(b) < 0.6,
                 kidx=rng.integers(0, 50, b).astype(np.int32),
                 version=rng.integers(0, 4, b).astype(np.int32),
                 vlen=rng.integers(0, 64, b).astype(np.int32))
    val = rng.integers(0, 256, (b, orbit.val.shape[1])).astype(np.uint8)
    frag = rng.integers(-1, f + 1, b).astype(np.int32)
    n_frags = rng.integers(0, f + 2, b).astype(np.int32)
    args = [cidx] + list(lanes.values())
    port, ref = from_numpy(orbit, "cpu"), _j(orbit)
    for kw in ({}, dict(frag=frag, n_frags=n_frags)):
        tkw = {k: _t(v) for k, v in kw.items()}
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        assert_trees_equal(
            ob.install_lines(port, *map(_t, args), _t(val), **tkw),
            _np(job.install_lines(ref, *map(jnp.asarray, args),
                                  jnp.asarray(val), **jkw)),
            f"install_lines {sorted(kw)}")
        meta = port._asdict()
        del meta["val"]
        jmeta = _np(ref)._asdict()
        del jmeta["val"]
        from repro.core.types import OrbitMeta as JMeta
        from repro_torch.core.types import OrbitMeta
        assert_trees_equal(
            ob.install_lines_meta(OrbitMeta(**meta), *map(_t, args), **tkw),
            _np(job.install_lines_meta(_j(JMeta(**jmeta)),
                                       *map(jnp.asarray, args), **jkw)),
            f"install_lines_meta {sorted(kw)}")
    # evictions with -1 (the last entry's lines, as the reference's
    # negative index has it), out-of-range entries and repeats
    ev = np.asarray([1, -1, c, 1, -c, c + 3, 0], np.int32)
    assert_trees_equal(ob.evict_lines(port, _t(ev)),
                       _np(job.evict_lines(ref, jnp.asarray(ev))),
                       "evict_lines")
