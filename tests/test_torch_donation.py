"""A chunk donates its carry: inside a chunk the servers' key-version table
is updated in place, and every other caller keeps the functional step.

The reference donates its scan's carry, so XLA bumps the write versions
in the table it was given.  The port's chunk owns its carry's buffers
(``CompiledChunk``), so its window body asks ``server_step`` for the same
in-place add; the table is then neither cloned (vmap's per-point clones
and stack, in a fleet) nor copied back.  A call from anywhere else
(``window_step``, ``fleet_window_step``, ``server_step`` without
``donate``) leaves its input as it was.

Small shapes, no reference: 4 servers, C = 8, a 16-lane client batch,
``value_pad`` 16, writes at 0.2; a fleet of 3 points.  The table
(``num_keys`` 200,000) is larger than the rest of a carry, so a body that
copied it back would show in ``copy_back_bytes``.  The ``cuda``-marked
case holds the graphed chunk against the plain loop on the card
(``python3 -m pytest -q -m cuda tests/test_torch_donation.py``) and skips
without one.
"""
import pytest
import torch

from repro_torch.analysis.rules import leaves
from repro_torch.core.controller import CacheController, ControllerConfig
from repro_torch.core.types import OP_R_REQ, OP_W_REQ, empty_batch
from repro_torch.kvstore import fleet as tfl
from repro_torch.kvstore import server as tsrv
from repro_torch.kvstore import simulator as tsim
from repro_torch.kvstore import workload as twl

RACK = dict(num_servers=4, cache_entries=8, client_batch=16, value_pad=16,
            subrounds=4, fetch_lanes=8, netcache_entries=16,
            netcache_table=64, netcache_value_limit=16, seed=11)
NUM_KEYS = 200_000
WORKLOAD = dict(num_keys=NUM_KEYS, offered_rps=0.3e6, write_ratio=0.2,
                value_sizes=((16, 0.5), (48, 0.3), (1024, 0.2)))
OFFERED = (0.2e6, 0.3e6, 0.4e6)     # the fleet's 3 points
CHUNK = 6
KINDS = ("rack", "fleet")
SCHEMES = ("orbitcache", "netcache")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wl():
    return twl.Workload(twl.WorkloadConfig(**WORKLOAD), device="cpu")


def make(kind, scheme, wl, **rack):
    """A preloaded rack or 3-point fleet on ``wl``'s device (graphed on the
    card), seeded as every other one."""
    cfg = tsim.RackConfig(**dict(RACK, scheme=scheme, **rack))
    if kind == "rack":
        sim = tsim.RackSimulator(cfg, wl, device=wl.device)
        k = cfg.cache_entries if scheme == "orbitcache" \
            else cfg.netcache_entries
        sim.preload(wl.hottest_keys(k))
    else:
        sim = tfl.BatchedRackSimulator(cfg, wl, offered_rps=OFFERED,
                                       device=wl.device)
        sim.preload()
    return sim


def plain_step(sim, carry):
    """One window of ``carry`` outside any chunk (the functional step)."""
    if isinstance(sim, tsim.RackSimulator):
        return tsim.window_step(sim.cfg, sim.server_cfg, sim.client_cfg,
                                sim.key_size, sim.wl.arrays, carry)
    return tfl.fleet_window_step(sim.cfg, sim.server_cfg, sim.client_cfg,
                                 sim.key_size, sim._wl, sim._wl_axes, carry)


def assert_carries_equal(got, want, label):
    want = dict(leaves(want))
    for path, t in leaves(got):
        assert torch.equal(t, want[path]), f"{label}: {path}"


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("kind", KINDS)
def test_chunk_updates_its_table_in_place(kind, scheme, device, wl):
    """Across three chunks the table keeps its memory, and the chunk's
    carry equals a plain ``window_step`` loop's bit for bit."""
    if device == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card; CUDA graphs have no CPU mode")
        wl = twl.Workload(twl.WorkloadConfig(**WORKLOAD), device="cuda")
    chunked, plain = make(kind, scheme, wl), make(kind, scheme, wl)
    start = plain.carry.servers.key_version.clone()
    ptrs = []
    for i in range(3):
        chunked.run_windows(CHUNK)
        for _ in range(CHUNK):
            plain.carry, _ = plain_step(plain, plain.carry)
        ptrs.append(chunked.carry.servers.key_version.data_ptr())
        assert_carries_equal(chunked.carry, plain.carry, f"chunk {i}")
    assert ptrs[1:] == ptrs[:-1]
    assert ptrs[0] == chunked.chunk.carry.servers.key_version.data_ptr()
    assert chunked.chunk.copy_back_bytes["window"] < NUM_KEYS * 4
    assert torch.sum(chunked.carry.servers.key_version
                     - start) > 0, "no write reached a server"


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("kind", KINDS)
def test_functional_step_leaves_its_input(kind, scheme, wl):
    """A window outside a chunk returns a new table and leaves the carry
    it was given bit for bit as it was."""
    sim = make(kind, scheme, wl)
    carry = tsim._clone_tree(sim.carry)
    for _ in range(CHUNK):
        kept = tsim._clone_tree(carry)
        new, _ = plain_step(sim, carry)
        assert_carries_equal(carry, kept, "the input carry")
        old_t, new_t = carry.servers.key_version, new.servers.key_version
        assert new_t is not old_t
        assert new_t.data_ptr() != old_t.data_ptr()
        carry = new
    assert torch.sum(carry.servers.key_version
                     - sim.carry.servers.key_version) > 0, "no write served"


@pytest.mark.parametrize("donate", (False, True))
def test_server_step_donates_only_when_asked(donate):
    """``server_step`` adds the served writes' versions into the table it
    is given only with ``donate``; the versions it returns are the same."""
    cfg = tsrv.ServerConfig(num_servers=2, queue_depth=8, cap_per_window=4,
                            value_pad=16)
    st = tsrv.init_servers(cfg, 64, CPU)
    st = st._replace(key_version=torch.arange(64, dtype=torch.int32))
    pk = empty_batch(6, 16, CPU)
    kidx = torch.tensor([3, 5, 3, 8, 9, 3], dtype=torch.int32)
    pk = pk._replace(
        op=torch.tensor([OP_W_REQ, OP_W_REQ, OP_W_REQ, OP_R_REQ, OP_W_REQ,
                         OP_R_REQ], dtype=torch.int32),
        kidx=kidx, server=kidx % 2, valid=torch.ones(6, dtype=torch.bool))
    table = st.key_version
    before = table.clone()
    st2, out = tsrv.server_step(st, cfg, pk, pk.valid,
                                torch.zeros(6, dtype=torch.int32),
                                torch.tensor(0.0), donate)
    want = before.clone()
    want[3] += 2
    want[5] += 1
    want[9] += 1
    assert torch.equal(st2.key_version, want)
    assert (st2.key_version is table) == donate
    assert torch.equal(table, want if donate else before)
    assert out.served_now.tolist() == [1, 4]   # cap 4: one read waits


def carry_bytes(carry) -> tuple[int, int]:
    """``(every tensor leaf's bytes, the table's)``."""
    total = sum(t.nbytes for _, t in leaves(carry))
    return total, carry.servers.key_version.nbytes


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("kind", KINDS)
def test_copy_back_leaves_out_the_table(kind, scheme, wl):
    """Neither body copies the table back: each copies less than one
    point's table, and less than the carry without it."""
    sim = make(kind, scheme, wl, track_popularity=scheme == "orbitcache")
    sim.run_windows(CHUNK)
    total, table = carry_bytes(sim.carry)
    got = sim.chunk.copy_back_bytes
    assert 0 < got["window"] < NUM_KEYS * 4
    assert got["window"] <= total - table
    if scheme != "orbitcache":       # no period body: no device controller
        assert "period" not in got
        return
    ctrl = ControllerConfig(active_size=8, max_size=8, k_report=4)
    if kind == "rack":
        sim.controller = CacheController(ctrl)
    else:
        sim.controllers = [CacheController(ctrl) for _ in OFFERED]
    ptr = sim.carry.servers.key_version.data_ptr()
    sim.run_periods(2, 4)
    assert 0 < got["period"] < NUM_KEYS * 4
    assert got["period"] <= total - table
    assert sim.carry.servers.key_version.data_ptr() == ptr
