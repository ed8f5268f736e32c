"""The port's distributed orbit ring (``repro_torch.core.distributed``)
against the reference's, in both ring forms.

A subprocess runs the reference ring of ``tests/test_distributed_ring.py``
on 8 forced host devices (the device count must be set before jax starts)
and dumps the start state, the packets and every step's ``RingState`` and
``RingServe`` to an ``.npz``.  The one change to that setup: the ring
counters keep ``init_ring_state``'s uint32 (the reference test sets them
int32), the dtype the port's counters stand for.  The port's
``StackedRing(8)`` must equal the dump leaf for leaf over the whole
revolution, and 8 gloo processes, each a ``ProcessRing`` position, must
each equal their row of it.  In process, on one position: the popularity
counter wraps as a uint32 and the others saturate, a position holding two
live lines of one entry serves the later line's value, and a one-rank
``ProcessRing`` equals ``StackedRing(1)``.
"""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repro.core import distributed as jdist
from repro.core.hashing import hash128_u32_np
from repro.core.types import OP_R_REQ
from repro.core.types import empty_batch as j_empty
from repro_torch.core import distributed as dist
from repro_torch.core.types import empty_batch
from repro_torch.interop import from_numpy, ring_state_from_numpy, to_numpy
from torch_parity import assert_flat_equal, assert_trees_equal, tree_from_flat

HERE = os.path.dirname(os.path.abspath(__file__))
D, C, S, L, PAD, B = 8, 16, 4, 4, 64, 8
U32_TOP = 2**32 - 1

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from repro.launch.mesh import make_mesh_compat
from repro.core import distributed as dist
from repro.core.hashing import hash128_u32, hash128_u32_np
from repro.core.types import OP_R_REQ, OP_NONE, PacketBatch

def flat(tree, prefix, out):
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            flat(getattr(tree, f), prefix + "." + f, out)
    else:
        out[prefix] = np.asarray(tree)
    return out

D, C, S, L, PAD, B = 8, 16, 4, 4, 64, 8
mesh = make_mesh_compat((D,), ("data",))
st0 = dist.init_ring_state(C, S, L, PAD)
stack = lambda x: jnp.broadcast_to(x, (D,) + x.shape).copy()
st = st0._replace(
    reqtab=jax.tree.map(stack, st0.reqtab),
    slice=jax.tree.map(stack, st0.slice),
    popularity=stack(st0.popularity), overflow=stack(st0.overflow),
    hits=stack(st0.hits))
keys = np.arange(4, dtype=np.int32)
hk = hash128_u32_np(keys)
st = st._replace(
    lookup=st0.lookup._replace(
        hkeys=st0.lookup.hkeys.at[:4].set(jnp.asarray(hk)),
        occupied=st0.lookup.occupied.at[:4].set(True),
        kidx=st0.lookup.kidx.at[:4].set(jnp.asarray(keys))),
    state=st0.state._replace(valid=st0.state.valid.at[:4].set(True)))
live = np.zeros((D, L), bool); cidx = np.full((D, L), -1, np.int32)
kidx = np.full((D, L), -1, np.int32); vlen = np.zeros((D, L), np.int32)
val = np.zeros((D, L, PAD), np.uint8)
for d in range(4):
    live[d,0]=True; cidx[d,0]=d; kidx[d,0]=d; vlen[d,0]=32; val[d,0,:32]=d+1
st = st._replace(slice=st.slice._replace(
    live=jnp.asarray(live), cidx=jnp.asarray(cidx), kidx=jnp.asarray(kidx),
    vlen=jnp.asarray(vlen), val=jnp.asarray(val)))
op = np.full((D, B), OP_NONE, np.int32); op[:, :4] = OP_R_REQ
kq = np.zeros((D, B), np.int32); kq[:, :4] = np.arange(4)
pk = PacketBatch(
    op=jnp.asarray(op), seq=jnp.arange(D*B, dtype=jnp.int32).reshape(D,B),
    hkey=hash128_u32(jnp.asarray(kq)), flag=jnp.zeros((D,B), jnp.int32),
    kidx=jnp.asarray(kq), vlen=jnp.full((D,B),32,jnp.int32),
    client=jnp.zeros((D,B),jnp.int32), port=jnp.zeros((D,B),jnp.int32),
    server=jnp.zeros((D,B),jnp.int32), ts=jnp.zeros((D,B),jnp.float32),
    valid=jnp.asarray(op==OP_R_REQ), val=jnp.zeros((D,B,PAD),jnp.uint8))
empty = jax.tree.map(jnp.zeros_like, pk)
step = jax.jit(dist.make_ring_step(mesh, ("data",), clones_per_visit=4))
out = flat(st, "st", {})
flat(pk, "pk", out)
flat(empty, "empty", out)
for k in range(D + 1):
    st, serve = step(st, pk if k == 0 else empty)
    flat(st, f"state{k}", out)
    flat(serve, f"serve{k}", out)
np.savez(sys.argv[1], **out)
print("DUMP_OK")
"""

WORKER = r"""
import sys
import numpy as np, torch
import torch.distributed as tdist
from repro_torch.core import distributed as dist
from repro_torch.core.types import empty_batch
from repro_torch.interop import to_numpy
from torch_parity import assert_trees_equal, tree_from_flat

path, rank, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
torch.set_num_threads(1)
tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                         rank=rank, world_size=8)
try:
    flat = dict(np.load(path))
    ring = dist.ProcessRing()
    tmpl = dist.init_ring_state(16, 4, 4, 64, "cpu")
    serve_t = dist.RingServe(*[None] * len(dist.RingServe._fields))
    pk_t = empty_batch(8, 64, "cpu")
    load = lambda t, name, dims=0: ring.local(
        tree_from_flat(t, flat, "cpu", name), dims)
    st = load(tmpl, "st", dist.RING_DIMS)
    pk, empty = load(pk_t, "pk"), load(pk_t, "empty")
    step = dist.make_ring_step(ring, clones_per_visit=4)
    for k in range(9):
        st, serve = step(st, pk if k == 0 else empty)
        assert_trees_equal(st, to_numpy(load(tmpl, f"state{k}",
                                             dist.RING_DIMS)),
                           f"rank {rank} step {k} state")
        assert_trees_equal(serve, to_numpy(load(serve_t, f"serve{k}")),
                           f"rank {rank} step {k} serve")
    print(f"RANK_OK {rank}")
finally:
    tdist.destroy_process_group()
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), HERE])
    env["OMP_NUM_THREADS"] = "1"
    return env


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(script, args, n=8, timeout=240):
    """Start ``n`` processes of ``script`` (rank, port appended to
    ``args``), wait for all; returns their standard outputs."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, *map(str, args), str(r), str(port)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {r} exited {rc}: {err[-3000:]}"
    return [out for _, out, _ in outs]


def dump_reference(script, path, timeout=600):
    p = subprocess.run([sys.executable, "-c", script, str(path)], env=_env(),
                       capture_output=True, text=True, timeout=timeout)
    assert "DUMP_OK" in p.stdout, p.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def ref_dump(tmp_path_factory):
    path = tmp_path_factory.mktemp("ring") / "ring.npz"
    return path, dump_reference(REF_SCRIPT, path)


def _start(flat):
    tmpl = dist.init_ring_state(C, S, L, PAD, "cpu")
    pk_t = empty_batch(B, PAD, "cpu")
    return (tree_from_flat(tmpl, flat, "cpu", "st"),
            tree_from_flat(pk_t, flat, "cpu", "pk"),
            tree_from_flat(pk_t, flat, "cpu", "empty"))


def test_stacked_ring_matches_reference_over_a_revolution(ref_dump):
    _, flat = ref_dump
    st, pk, empty = _start(flat)
    step = dist.make_ring_step(dist.StackedRing(D), clones_per_visit=4)
    total, vals_seen, n = 0, [], 0
    for k in range(D + 1):
        st, serve = step(st, pk if k == 0 else empty)
        n += assert_flat_equal(st, flat, f"step {k} state", f"state{k}")
        n += assert_flat_equal(serve, flat, f"step {k} serve", f"serve{k}")
        total += int(serve.served.sum())
        for d in range(D):
            for c in range(4):
                if bool(serve.served[d, c].any()):
                    vals_seen.append((c, int(serve.val[d, c, 0])))
    assert n == (D + 1) * 31
    # the reference test's revolution checks, on the port
    assert total == D * 4
    assert all(byte == c + 1 for c, byte in vals_seen)
    assert int(st.reqtab.qlen.sum()) == 0


def test_process_ring_gloo_matches_reference(ref_dump):
    path, _ = ref_dump
    outs = run_ranks(WORKER, [path])
    for r, out in enumerate(outs):
        assert f"RANK_OK {r}" in out, out


def _one_position(seed_lines):
    """A D = 1 reference ring state (numpy) with entries 0..3 installed
    and the given slice lines ``[(cidx, kidx, byte)]``."""
    st = jax.tree.map(np.asarray, jdist.init_ring_state(C, S, L, PAD))
    stack = lambda x: x[None].copy()
    keys = np.arange(4, dtype=np.int32)
    hk = st.lookup.hkeys.copy()
    hk[:4] = hash128_u32_np(keys)
    occ = st.lookup.occupied.copy()
    occ[:4] = True
    kx = st.lookup.kidx.copy()
    kx[:4] = keys
    valid = st.state.valid.copy()
    valid[:4] = True
    sl = jax.tree.map(stack, st.slice)
    for i, (c, k, byte) in enumerate(seed_lines):
        sl.live[0, i], sl.cidx[0, i], sl.kidx[0, i] = True, c, k
        sl.vlen[0, i] = 32
        sl.val[0, i, :32] = byte
    return st._replace(
        lookup=st.lookup._replace(hkeys=hk, occupied=occ, kidx=kx),
        state=st.state._replace(valid=valid),
        reqtab=jax.tree.map(stack, st.reqtab), slice=sl,
        popularity=stack(st.popularity), overflow=stack(st.overflow),
        hits=stack(st.hits))


def _reads(keys, b=B):
    """One position's batch of reads of ``keys`` (reference, numpy)."""
    pk = jax.tree.map(lambda x: np.asarray(x)[None].copy(),
                      j_empty(b, value_pad=PAD))
    n = len(keys)
    pk.op[0, :n] = OP_R_REQ
    pk.kidx[0, :n] = keys
    pk.hkey[0, :n] = hash128_u32_np(np.asarray(keys, np.int32))
    pk.valid[0, :n] = True
    return pk._replace(seq=np.arange(b, dtype=np.int32)[None])


def _ref_one_position_steps(st, pks):
    from repro.launch.mesh import make_mesh_compat
    mesh = make_mesh_compat((1,), ("data",))
    step = jax.jit(jdist.make_ring_step(mesh, ("data",), clones_per_visit=4))
    out, jst = [], jax.tree.map(jnp.asarray, st)
    for pk in pks:
        jst, serve = step(jst, jax.tree.map(jnp.asarray, pk))
        out.append(jax.tree.map(np.asarray, (jst, serve)))
    return out


def _port_steps(ring, st, pks):
    step = dist.make_ring_step(ring, clones_per_visit=4)
    out = []
    for pk in pks:
        st, serve = step(st, pk)
        out.append((st, serve))
    return out


def test_popularity_wraps_and_counters_saturate():
    st = _one_position([(0, 0, 1), (1, 1, 2)])
    st = st._replace(popularity=np.full_like(st.popularity, U32_TOP),
                     hits=np.full_like(st.hits, U32_TOP - 1),
                     overflow=np.full_like(st.overflow, U32_TOP - 1))
    # key 0 thrice (its count wraps past 2**32 - 1); key 1 five times
    # into a queue of 4 (one overflow)
    pks = [_reads([0, 0, 0, 1, 1, 1, 1, 1]), _reads([1, 2, 0])]
    want = _ref_one_position_steps(st, pks)
    assert int(want[0][0].popularity[0, 0]) == 2           # wrapped
    assert int(want[0][0].hits[0]) == U32_TOP               # saturated
    assert int(want[0][0].overflow[0]) == U32_TOP
    got = _port_steps(dist.StackedRing(1), ring_state_from_numpy(st, "cpu"),
                      [from_numpy(pk, "cpu") for pk in pks])
    for k, (g, w) in enumerate(zip(got, want)):
        assert_trees_equal(g, w, f"step {k}")


def test_repeated_entry_lines_serve_the_later_line():
    """One position holds two live lines of entry 0 (bytes 7 and 9): the
    budget counts both, and the served value is the later line's, which
    is what XLA's scatter order gives the reference here."""
    st = _one_position([(0, 0, 7), (2, 2, 5), (0, 0, 9)])
    pks = [_reads([0] * 6 + [2]), _reads([0, 0])]
    want = _ref_one_position_steps(st, pks)
    assert int(want[0][1].val[0, 0, 0]) == 9
    assert int(want[0][1].served[0, 0].sum()) == 4    # 2 lines x 4, S = 4
    got = _port_steps(dist.StackedRing(1), ring_state_from_numpy(st, "cpu"),
                      [from_numpy(pk, "cpu") for pk in pks])
    for k, (g, w) in enumerate(zip(got, want)):
        assert_trees_equal(g, w, f"step {k}")


def test_one_rank_process_ring_equals_stacked():
    st = ring_state_from_numpy(_one_position([(0, 0, 1), (3, 3, 4)]), "cpu")
    pks = [from_numpy(_reads(k), "cpu") for k in ([0, 3, 3, 1], [], [0])]
    stacked = _port_steps(dist.StackedRing(1), st, pks)
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                             f"{free_port()}", rank=0, world_size=1)
    try:
        ring = dist.ProcessRing()
        got = _port_steps(ring, ring.local(st, dist.RING_DIMS),
                          [ring.local(pk) for pk in pks])
    finally:
        tdist.destroy_process_group()
    for k, ((g_st, g_sv), (w_st, w_sv)) in enumerate(zip(got, stacked)):
        assert_trees_equal(g_st, to_numpy(ring.local(w_st, dist.RING_DIMS)),
                           f"step {k} state")
        assert_trees_equal(g_sv, to_numpy(ring.local(w_sv)), f"step {k} serve")


@pytest.mark.parametrize("seed", range(4))
def test_install_into_slice_matches_reference(seed):
    rng = np.random.default_rng(seed)
    l, b = 8, 12
    sl = jax.tree.map(np.asarray, jdist.init_ring_state(C, S, l, PAD).slice)
    sl = sl._replace(live=rng.random(l) < 0.5,
                     cidx=rng.integers(-1, C, l).astype(np.int32),
                     val=rng.integers(0, 256, (l, PAD)).astype(np.uint8))
    lanes = [rng.integers(0, C, b).astype(np.int32), rng.random(b) < 0.6,
             rng.integers(0, 99, b).astype(np.int32),
             rng.integers(0, 5, b).astype(np.int32),
             rng.integers(0, PAD, b).astype(np.int32),
             rng.integers(0, 256, (b, PAD)).astype(np.uint8)]
    want = jax.tree.map(np.asarray, jdist.install_into_slice(
        jax.tree.map(jnp.asarray, sl), *map(jnp.asarray, lanes)))
    got = dist.install_into_slice(
        ring_state_from_numpy(sl, "cpu"),
        *(torch.from_numpy(np.array(a)) for a in lanes))
    assert_trees_equal(got, want, "install_into_slice")
