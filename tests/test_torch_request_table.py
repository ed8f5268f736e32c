"""The port's request table (``repro_torch.core.request_table``) against
the reference's: the scenarios of ``tests/test_request_table.py`` (FIFO,
isolation, overflow, wraparound, the deque model) on the port, then each
function against the reference on seeded inputs, bit for bit."""
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import request_table as jrt
from repro.core import scatter_free as jsf
from repro.core.types import init_switch_state as j_init
from repro_torch.core import request_table as rt
from repro_torch.core.types import init_switch_state
from repro_torch.interop import from_numpy
from torch_parity import assert_trees_equal

I32 = torch.int32


def fresh(c=4, s=4):
    return init_switch_state(c, s, value_pad=8, device="cpu").reqtab


def enq(table, cidxs, base_seq=0):
    n = len(cidxs)
    ar = torch.arange(n, dtype=I32)
    return rt.enqueue(table, torch.tensor(cidxs, dtype=I32),
                      torch.ones(n, dtype=torch.bool), client=ar + 100,
                      seq=ar + base_seq, port=torch.zeros(n, dtype=I32),
                      ts=torch.zeros(n))


def full(c, v):
    return torch.full((c,), v, dtype=I32)


def test_fifo_order_single_key():
    res = enq(fresh(), [1, 1, 1])
    deq = rt.peek_front(res.table, full(4, 8), 4)
    assert deq.served[1].tolist() == [True, True, True, False]
    assert deq.seq[1, :3].tolist() == [0, 1, 2]


def test_isolation_between_keys():
    res = enq(fresh(), [0, 1, 2, 0, 1, 0])
    assert res.table.qlen.tolist() == [3, 2, 1, 0]
    deq = rt.peek_front(res.table, full(4, 8), 4)
    assert deq.seq[0, :3].tolist() == [0, 3, 5]
    assert deq.seq[1, :2].tolist() == [1, 4]
    assert deq.seq[2, :1].tolist() == [2]


def test_overflow_to_server():
    res = enq(fresh(c=2, s=2), [0, 0, 0, 0])
    assert res.accepted.tolist() == [True, True, False, False]
    assert res.overflow.tolist() == [False, False, True, True]
    assert int(res.table.qlen[0]) == 2


def test_wraparound():
    res = enq(fresh(c=1, s=4), [0, 0, 0])
    t2 = rt.pop(res.table, torch.tensor([2], dtype=I32))
    assert int(t2.front[0]) == 2 and int(t2.qlen[0]) == 1
    res2 = enq(t2, [0, 0, 0], base_seq=10)
    assert int(res2.table.rear[0]) == 2     # 3 + 3 = 6 mod 4
    deq = rt.peek_front(res2.table, full(1, 8), 4)
    assert deq.seq[0].tolist() == [2, 10, 11, 12]


def test_matches_deque_model():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=60, deadline=None)
    @given(st.lists(st.tuples(st.sampled_from(["enq", "pop"]),
                              st.integers(0, 2), st.integers(1, 3)),
                    min_size=1, max_size=30))
    def check(ops):
        _run_deque_model(ops)

    check()


def test_matches_deque_model_deterministic():
    _run_deque_model([("enq", 0, 3), ("pop", 0, 2), ("enq", 1, 2),
                      ("enq", 0, 3), ("pop", 1, 1), ("enq", 2, 3),
                      ("pop", 0, 3), ("enq", 0, 2)])


def _run_deque_model(ops):
    c, s = 3, 4
    table = fresh(c, s)
    model = [deque() for _ in range(c)]
    seq = 0
    for kind, key, count in ops:
        if kind == "enq":
            table = enq(table, [key] * count, base_seq=seq).table
            for i in range(count):
                if len(model[key]) < s:
                    model[key].append(seq + i)
            seq += count
        else:
            npop = torch.zeros(c, dtype=I32)
            npop[key] = count
            table = rt.pop(table, npop)
            for _ in range(min(count, len(model[key]))):
                model[key].popleft()
        assert table.qlen.tolist() == [len(m) for m in model]
    deq = rt.peek_front(table, full(c, s), s)
    for k in range(c):
        assert deq.seq[k][deq.served[k]].tolist() == list(model[k])


# ---------------------------------------------------------------------------
# seeded parity against the reference
# ---------------------------------------------------------------------------
def _table(rng, c, s):
    """A reference request table in a random reachable state (numpy)."""
    t = j_init(c, s, value_pad=8).reqtab
    qlen = rng.integers(0, s + 1, c).astype(np.int32)
    front = rng.integers(0, s, c).astype(np.int32)
    n = c * s
    return t._replace(
        client=rng.integers(-1, 9, n).astype(np.int32),
        seq=rng.integers(0, 1000, n).astype(np.int32),
        port=rng.integers(0, 3, n).astype(np.int32),
        ts=rng.random(n, dtype=np.float32) * 100,
        acked=rng.integers(0, 3, n).astype(np.int32),
        kidx=rng.integers(-1, 50, n).astype(np.int32),
        qlen=qlen, front=front, rear=((front + qlen) % s).astype(np.int32))


def _lanes(rng, b, c):
    return dict(
        cidx=rng.integers(-1, c, b).astype(np.int32),
        want=rng.random(b) < 0.7,
        client=rng.integers(0, 8, b).astype(np.int32),
        seq=rng.integers(0, 1000, b).astype(np.int32),
        port=rng.integers(0, 3, b).astype(np.int32),
        ts=rng.random(b, dtype=np.float32) * 100,
        kidx=rng.integers(0, 50, b).astype(np.int32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


CASES = [(seed, b, c, s) for seed, (b, c, s) in
         enumerate([(8, 4, 4), (24, 8, 4), (40, 5, 3), (64, 16, 8),
                    (16, 1, 8)])]


@pytest.mark.parametrize("seed,b,c,s", CASES)
def test_enqueue_matches_reference(seed, b, c, s):
    rng = np.random.default_rng(seed)
    table = _table(rng, c, s)
    ln = _lanes(rng, b, c)
    # want only where the packet has an entry, as every caller does
    ln["want"] &= ln["cidx"] >= 0
    for with_kidx in (False, True):
        kidx = ln["kidx"] if with_kidx else None
        want = _np(jrt.enqueue(_j(table), *(jnp.asarray(ln[k]) for k in (
            "cidx", "want", "client", "seq", "port", "ts")),
            kidx=None if kidx is None else jnp.asarray(kidx)))
        got = rt.enqueue(from_numpy(table, "cpu"), *(_t(ln[k]) for k in (
            "cidx", "want", "client", "seq", "port", "ts")),
            kidx=None if kidx is None else _t(kidx))
        assert_trees_equal(got, want, f"enqueue kidx={with_kidx}")


@pytest.mark.parametrize("seed,b,c,s", CASES)
def test_apply_winners_matches_reference(seed, b, c, s):
    rng = np.random.default_rng(100 + seed)
    table = _table(rng, c, s)
    ln = _lanes(rng, b, c)
    dest = rng.permutation(c * s + b)[:b].astype(np.int32)  # distinct
    writer, written = _np(jsf.unique_writer(jnp.asarray(dest),
                                            jnp.asarray(ln["want"]), c * s))
    counts = rng.integers(0, s + 1, c).astype(np.int32)
    meta = [ln[k] for k in ("client", "seq", "port", "ts")]
    want = _np(jrt.apply_winners(_j(table), writer, written, counts,
                                 *map(jnp.asarray, meta),
                                 kidx=jnp.asarray(ln["kidx"])))
    got = rt.apply_winners(from_numpy(table, "cpu"), _t(writer),
                           _t(written), _t(counts), *map(_t, meta),
                           kidx=_t(ln["kidx"]))
    assert_trees_equal(got, want, "apply_winners")


@pytest.mark.parametrize("seed,b,c,s", CASES)
def test_peek_pop_ack_match_reference(seed, b, c, s):
    rng = np.random.default_rng(200 + seed)
    table = _table(rng, c, s)
    port = from_numpy(table, "cpu")
    budget = rng.integers(0, s + 2, c).astype(np.int32)
    for j in (1, s, s + 3):
        want = _np(jrt.peek_front(_j(table), jnp.asarray(budget), j))
        got = rt.peek_front(port, _t(budget), j)
        assert_trees_equal(got, want, f"peek_front J={j}")
    n_pop = rng.integers(0, s + 3, c).astype(np.int32)
    assert_trees_equal(rt.pop(port, _t(n_pop)),
                       _np(jrt.pop(_j(table), jnp.asarray(n_pop))), "pop")
    ar = np.arange(c, dtype=np.int32)
    frag_hits = rng.integers(0, 3, c).astype(np.int32)
    frags = rng.integers(1, 4, c).astype(np.int32)
    want = _np(jrt.ack_fragments(_j(table), *map(jnp.asarray,
                                             (ar, frag_hits, frags))))
    got = rt.ack_fragments(port, *map(_t, (ar, frag_hits, frags)))
    assert_trees_equal(got, want, "ack_fragments")
