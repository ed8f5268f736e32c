"""The port's NetCache and NoCache switch passes against the JAX reference.

``netcache_step`` and ``nocache_step`` run batch by batch, the state
threaded through, over fuzzed batches that carry every op (R/W-REQ,
R/W-REP, F-REQ/REP, CRN-REQ, empty lanes) and repeat keys, so that two
install lanes of one batch hit one slot with different bytes (the last
must win) and a write and an install meet in one batch.  A small table
(64 slots) makes the two probes collide, and a value limit below the
packets' ``value_pad`` makes the byte cut and the install refusals run.
Every output and every state leaf must equal the reference exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.baselines import netcache as jnc  # noqa: E402
from repro.baselines import nocache as jno  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.core.hashing import hash128_u32_np  # noqa: E402
from repro.kvstore.store import synth_value_np as jax_synth_np  # noqa: E402
from torch_parity import assert_trees_equal  # noqa: E402

from repro_torch.baselines import netcache as tnc  # noqa: E402
from repro_torch.baselines import nocache as tno  # noqa: E402
from repro_torch.core.hashing import fold_hash  # noqa: E402
from repro_torch.interop import from_numpy  # noqa: E402
from repro_torch.kvstore.store import synth_value_np  # noqa: E402

TABLE, LIMIT, PAD, LANES = 64, 24, 32, 64
CPU = torch.device("cpu")
# one compile per shape: the reference step, jitted as the simulator runs it
JAX_NETCACHE_STEP = jax.jit(jnc.netcache_step)
JAX_NOCACHE_STEP = jax.jit(jno.nocache_step)


def fuzz_batch(rng, b, universe):
    """numpy fields of a PacketBatch: every op, repeated keys, flags in
    {0, 1, 2}, value lengths on both sides of the limit, random bytes."""
    kidx = rng.integers(0, universe, b).astype(np.int32)
    op = rng.integers(0, 8, b).astype(np.int32)
    valid = (rng.random(b) < 0.85) & (op != jtypes.OP_NONE)
    i32 = lambda a: np.asarray(a, np.int32)
    return dict(
        op=op, seq=i32(rng.integers(0, 1 << 20, b)),
        hkey=hash128_u32_np(kidx), flag=i32(rng.integers(0, 3, b)),
        kidx=kidx, vlen=i32(rng.integers(0, 2 * PAD, b)),
        client=i32(rng.integers(0, 4, b)), port=i32(rng.integers(0, 9, b)),
        server=i32(rng.integers(0, 4, b)),
        ts=rng.random(b).astype(np.float32), valid=valid,
        val=rng.integers(0, 256, (b, PAD)).astype(np.uint8))


def both_batches(fields):
    jax_b = jtypes.PacketBatch(**{k: jnp.asarray(v)
                                  for k, v in fields.items()})
    return jax_b, from_numpy(jtypes.PacketBatch(**fields), CPU)


def preloaded(rng, universe, n_keys, key_size=16):
    """The reference's table after ``netcache_install`` of ``n_keys`` keys
    with mixed value lengths, and the port's state built the same way."""
    keys = rng.choice(universe, n_keys, replace=False).astype(np.int32)
    vlens = rng.integers(1, 2 * LIMIT, n_keys).astype(np.int32)
    j_st, j_n = jnc.netcache_install(jnc.init_netcache(TABLE, LIMIT), keys,
                                     vlens, key_size=key_size,
                                     value_limit=LIMIT)
    t_st, t_n = tnc.netcache_install(tnc.init_netcache(TABLE, LIMIT, CPU),
                                     keys, vlens, key_size=key_size,
                                     value_limit=LIMIT)
    return (j_st, j_n), (t_st, t_n), keys, vlens


@pytest.mark.parametrize("seed", range(6))
def test_netcache_install_matches_jax(seed):
    """Refusals (values over the limit), probe collisions in 64 slots and
    a second install of the same keys, which refreshes their slots."""
    rng = np.random.default_rng(seed)
    (j_st, j_n), (t_st, t_n), keys, vlens = preloaded(rng, 400, 150)
    assert t_n == j_n
    assert 0 < j_n < int((vlens <= LIMIT).sum())      # probes ran out
    assert_trees_equal(t_st, jax.tree.map(np.asarray, j_st), "install")
    vl2 = rng.integers(1, LIMIT + 1, keys.shape[0]).astype(np.int32)
    j2, jn2 = jnc.netcache_install(j_st, keys, vl2, 16, LIMIT)
    t2, tn2 = tnc.netcache_install(t_st, keys, vl2, 16, LIMIT)
    assert tn2 == jn2
    assert_trees_equal(t2, jax.tree.map(np.asarray, j2), "reinstall")


def test_netcache_install_refuses_long_keys():
    rng = np.random.default_rng(9)
    (j_st, j_n), (t_st, t_n), _, _ = preloaded(rng, 100, 20, key_size=17)
    assert j_n == t_n == 0
    assert_trees_equal(t_st, jax.tree.map(np.asarray, j_st), "long keys")


@pytest.mark.parametrize("seed", range(8))
def test_netcache_step_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    universe = 40
    (j_st, _), (t_st, _), _, _ = preloaded(rng, universe, 30)
    n_install = n_hit = n_write = 0
    for step in range(6):
        fields = fuzz_batch(rng, LANES, universe)
        jb, tb = both_batches(fields)
        j_st, *j_out = JAX_NETCACHE_STEP(j_st, jb)
        t_st, *t_out = tnc.netcache_step(t_st, tb)
        label = f"seed {seed} step {step}"
        for name, g, w in zip(("route", "flag", "switch_reply", "n_hit"),
                              t_out, j_out):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype, f"{label}: {name}"
            np.testing.assert_array_equal(g.numpy(), w,
                                          err_msg=f"{label}: {name}")
        assert_trees_equal(t_st, jax.tree.map(np.asarray, j_st), label)
        n_hit += int(j_out[3])
        op, valid = fields["op"], fields["valid"]
        n_write += int((valid & (op == jtypes.OP_W_REQ)).sum())
        n_install += int((valid & np.isin(op, (jtypes.OP_W_REP,
                                               jtypes.OP_F_REP))).sum())
    assert n_hit and n_write and n_install


def test_netcache_repeated_install_slot_last_lane_wins():
    """Two W-REPs of one cached key in one batch, with different bytes
    and lengths: the later lane's value is installed, in both packages."""
    rng = np.random.default_rng(7)
    (j_st, _), (t_st, _), keys, vlens = preloaded(rng, 50, 10)
    k = int(keys[vlens <= LIMIT][0])
    fields = fuzz_batch(rng, 6, 50)
    fields.update(op=np.full(6, jtypes.OP_W_REP, np.int32),
                  kidx=np.full(6, k, np.int32),
                  hkey=hash128_u32_np(np.full(6, k, np.int32)),
                  flag=np.ones(6, np.int32), valid=np.ones(6, bool),
                  vlen=np.array([3, 9, 30, 5, 12, 7], np.int32))
    jb, tb = both_batches(fields)
    j_st, *_ = JAX_NETCACHE_STEP(j_st, jb)
    t_st, *_ = tnc.netcache_step(t_st, tb)
    assert_trees_equal(t_st, jax.tree.map(np.asarray, j_st), "repeated")
    slot = int(np.flatnonzero(np.asarray(j_st.kidx) == k)[0])
    assert int(t_st.vlen[slot]) == 7
    np.testing.assert_array_equal(t_st.val[slot].numpy(),
                                  fields["val"][5, :LIMIT])


@pytest.mark.parametrize("seed", range(4))
def test_nocache_step_matches_jax(seed):
    rng = np.random.default_rng(200 + seed)
    for step in range(3):
        jb, tb = both_batches(fuzz_batch(rng, LANES, 40))
        j_st, j_route, j_flag = JAX_NOCACHE_STEP((), jb)
        t_st, t_route, t_flag = tno.nocache_step((), tb)
        assert t_st == j_st == ()
        np.testing.assert_array_equal(t_route.numpy(), np.asarray(j_route))
        np.testing.assert_array_equal(t_flag.numpy(), np.asarray(j_flag))
        assert t_route.dtype == torch.int32


def test_host_fold_and_synthetic_bytes_match():
    """The host fold equals the device ``fold_hash`` and the reference's
    ``_fold_np``; ``synth_value_np`` equals the reference's."""
    keys = np.array([0, 1, 7, 2**31 - 1, -1, 123456], np.int32)
    hk = hash128_u32_np(keys)
    for salt in (100, 101, 5):
        dev = fold_hash(torch.from_numpy(hk.view(np.int32)), TABLE, salt)
        for i in range(len(keys)):
            assert tnc._fold_np(hk[i], TABLE, salt) == \
                jnc._fold_np(hk[i], TABLE, salt) == int(dev[i])
    for k, v in ((0, 0), (5, 3), (2**31 - 1, 7), (-4, 0)):
        np.testing.assert_array_equal(synth_value_np(k, v, 40),
                                      jax_synth_np(k, v, 40))
