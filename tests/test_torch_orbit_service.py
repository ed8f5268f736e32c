"""The port's orbit-backed KV service (``repro_torch.serving.orbit_service``)
against the reference's, in both ring forms.

A subprocess runs the reference service of ``tests/test_orbit_service.py``
on 8 forced host devices and dumps the start state, the lookups and every
step's state, values, cold and hot masks and ``RingServe``; the port's
``StackedRing(8)`` must equal the dump leaf for leaf, and 8 gloo processes,
each a ``ProcessRing`` position, must each equal their row of it.  The
reference test's own conditions hold on the port: the cold values are the
owner shards' bytes, and one revolution serves the D x 2 hot lookups.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import distributed as dist
from repro_torch.interop import to_numpy
from repro_torch.serving import orbit_service as svc
from test_torch_distributed_ring import dump_reference, run_ranks
from torch_parity import assert_trees_equal, tree_from_flat

D, NUM_KEYS, LANES = 8, 64, 16
CFG = svc.ServiceConfig(num_entries=16, queue_size=4, slice_len=4,
                        value_pad=32, local_batch=LANES, a2a_quota=8)

REF_SCRIPT = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from repro.launch.mesh import make_mesh_compat
from repro.serving import orbit_service as svc
from repro.core.hashing import hash128_u32_np

def flat(tree, prefix, out):
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            flat(getattr(tree, f), prefix + "." + f, out)
    else:
        out[prefix] = np.asarray(tree)
    return out

D = 8
mesh = make_mesh_compat((D,), ("data",))
cfg = svc.ServiceConfig(num_entries=16, queue_size=4, slice_len=4,
                        value_pad=32, local_batch=16, a2a_quota=8)
NUM_KEYS = 64
st = svc.init_service(cfg, NUM_KEYS, D)
vals = np.zeros((D, NUM_KEYS // D, 32), np.uint8)
for d in range(D):
    for i in range(NUM_KEYS // D):
        vals[d, i, :] = (d * (NUM_KEYS // D) + i) % 251
st = st._replace(store_vals=jnp.asarray(vals))
keys = np.arange(4, dtype=np.int32)
hk = hash128_u32_np(keys)
rs = st.ring
lookup = rs.lookup._replace(
    hkeys=rs.lookup.hkeys.at[:4].set(jnp.asarray(hk)),
    occupied=rs.lookup.occupied.at[:4].set(True),
    kidx=rs.lookup.kidx.at[:4].set(jnp.asarray(keys)))
state = rs.state._replace(valid=rs.state.valid.at[:4].set(True))
sl = rs.slice
live = np.zeros((D, 4), bool); cidx = np.full((D, 4), -1, np.int32)
kidx = np.full((D, 4), -1, np.int32); vlen = np.zeros((D, 4), np.int32)
sval = np.zeros((D, 4, 32), np.uint8)
for c in range(4):
    live[c, 0] = True; cidx[c, 0] = c; kidx[c, 0] = c; vlen[c, 0] = 32
    sval[c, 0, :] = c % 251
st = st._replace(ring=rs._replace(lookup=lookup, state=state, slice=sl._replace(
    live=jnp.asarray(live), cidx=jnp.asarray(cidx), kidx=jnp.asarray(kidx),
    vlen=jnp.asarray(vlen), val=jnp.asarray(sval))))
step = jax.jit(svc.make_service_step(mesh, ("data",), cfg))
rng = np.random.default_rng(0)
keys_req = np.zeros((D, 16), np.int32)
keys_req[:, 0] = 0; keys_req[:, 1] = 1
keys_req[:, 2:] = rng.integers(8, 64, (D, 14))
out = flat(st, "st", {})
out["keys"] = keys_req
for k in range(D + 1):
    kq = keys_req if k == 0 else np.zeros_like(keys_req)
    mask = np.full((D, 16), k == 0)
    st, res, cold, hot, serve = step(st, jnp.asarray(kq), jnp.asarray(mask))
    flat(st, f"state{k}", out)
    flat(serve, f"serve{k}", out)
    out[f"values{k}"], out[f"cold{k}"], out[f"hot{k}"] = map(
        np.asarray, (res, cold, hot))
np.savez(sys.argv[1], **out)
print("DUMP_OK")
'''

WORKER = r'''
import sys
import numpy as np, torch
import torch.distributed as tdist
from repro_torch.core import distributed as dist
from test_torch_orbit_service import run_service

path, rank, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
torch.set_num_threads(1)
tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                         rank=rank, world_size=8)
try:
    run_service(dist.ProcessRing(), dict(np.load(path)))
    print(f"RANK_OK {rank}")
finally:
    tdist.destroy_process_group()
'''


def run_service(ring, flat):
    """Step the service over a revolution on ``ring`` from the dump's start,
    holding every output against the dump (a ``ProcessRing`` against its
    own row).  Returns ``(keys, per-step (values, cold, hot, serve))`` in
    the ring's own shapes."""
    st_t = svc.init_service(CFG, NUM_KEYS, D, device="cpu")
    serve_t = dist.RingServe(*[None] * len(dist.RingServe._fields))
    if isinstance(ring, dist.StackedRing):
        local = lambda tree, dims=0: tree
    else:
        local = ring.local
    load = lambda t, name, dims=0: local(
        tree_from_flat(t, flat, "cpu", name), dims)
    st = load(st_t, "st", svc.SERVICE_DIMS)
    keys = local(torch.from_numpy(flat["keys"]))
    step = svc.make_service_step(ring, CFG)
    outs = []
    for k in range(D + 1):
        mask = torch.full(keys.shape, k == 0)
        st, res, cold, hot, serve = step(
            st, keys if k == 0 else torch.zeros_like(keys), mask)
        assert_trees_equal(st, to_numpy(load(st_t, f"state{k}",
                                             svc.SERVICE_DIMS)),
                           f"step {k} state")
        assert_trees_equal(serve, to_numpy(load(serve_t, f"serve{k}")),
                           f"step {k} serve")
        for name, got in (("values", res), ("cold", cold), ("hot", hot)):
            want = local(torch.from_numpy(flat[f"{name}{k}"])).numpy()
            assert got.numpy().dtype == want.dtype, name
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"step {k} {name}")
        outs.append((res, cold, hot, serve))
    return keys, outs


@pytest.fixture(scope="module")
def ref_dump(tmp_path_factory):
    path = tmp_path_factory.mktemp("service") / "service.npz"
    return path, dump_reference(REF_SCRIPT, path)


def test_stacked_service_matches_reference(ref_dump):
    _, flat = ref_dump
    keys, outs = run_service(dist.StackedRing(D), flat)
    res, cold, hot, _ = outs[0]
    # the reference test's conditions, on the port: byte-exact cold values
    n_cold = int(cold.sum())
    assert n_cold > 0
    got = res[cold][:, 0].numpy()
    np.testing.assert_array_equal(got, keys[cold].numpy() % 251)
    assert bool(hot[:, :2].all()) and not bool(hot[:, 2:].any())
    # one revolution serves every hot lookup exactly once
    served = sum(int(o[3].served.sum()) for o in outs)
    assert served == D * 2 == int(hot.sum())


def test_process_ring_gloo_matches_reference(ref_dump):
    path, _ = ref_dump
    outs = run_ranks(WORKER, [path])
    for r, out in enumerate(outs):
        assert f"RANK_OK {r}" in out, out


def test_init_service_matches_reference():
    """The port's empty service and ring state equal the reference's, and
    ``service_state_from_numpy`` carries the reference's across."""
    import jax

    from repro.serving import orbit_service as jsvc
    from repro_torch.interop import service_state_from_numpy

    want = jax.tree.map(np.asarray, jsvc.init_service(CFG, NUM_KEYS, D))
    assert_trees_equal(svc.init_service(CFG, NUM_KEYS, D, device="cpu"),
                       want, "init_service")
    assert_trees_equal(service_state_from_numpy(want, "cpu"), want,
                       "service_state_from_numpy")
