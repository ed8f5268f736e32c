"""The port's orbit_match against the JAX reference.

``cidx`` is the first occupied entry whose 128-bit hash equals the lane's,
or -1; ``hit``, ``valid_hit`` and the masked per-entry popularity ``pop``
follow.  The port's dispatcher and plain version (both on the CPU) must
equal the JAX ``orbit_match_ref`` exactly on every case, and the
Pallas kernel under the interpreter on a subset: the sweep, property,
mask, empty-table and all-invalid cases of ``tests/test_kernels.py``, plus
duplicate table entries (some unoccupied) and flags of -1 and 2 (a flag is
true only where it is > 0).  On a card, the CUDA kernel must equal the
plain version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import kernels as jkn  # noqa: E402
from repro.core.hashing import hash128_u32_np  # noqa: E402
from repro.kernels.orbit_match.ref import orbit_match_ref as jax_ref  # noqa: E402,E501

from repro_torch import kernels as kn  # noqa: E402
from repro_torch.kernels.orbit_match import ops, ref  # noqa: E402
from repro_torch.kernels.orbit_match.kernel import (  # noqa: E402
    CHUNK, CLUSTER_LANES)

SWEEP = [(8, 8), (64, 16), (300, 128), (1024, 512), (17, 5)]
FLAGS = np.array([-1, 0, 1, 2], np.int32)


def make_case(seed, b, c, occ=None, val=None, mask=False, universe=None,
              dup=False):
    """numpy (hkey uint32[B, 4], table uint32[C, 4], occupied, valid,
    pop_mask): keys from a small universe (repeats allowed), as
    ``tests/test_kernels.py`` draws them, unless ``dup`` copies a quarter
    of the entries onto others; flags drawn from {-1, 0, 1, 2} unless
    given."""
    rng = np.random.default_rng(seed)
    universe = universe or 50
    keys = rng.integers(0, universe, c).astype(np.int32)
    if dup:
        n = max(1, c // 4)
        keys[rng.integers(0, c, n)] = keys[rng.integers(0, c, n)]
    q = rng.integers(0, universe + 10, b).astype(np.int32)
    occ = rng.choice(FLAGS, c) if occ is None else occ
    val = rng.choice(FLAGS, c) if val is None else val
    pm = rng.choice(FLAGS, b) if mask else None
    return (hash128_u32_np(q), hash128_u32_np(keys),
            np.asarray(occ, np.int32), np.asarray(val, np.int32), pm)


def jax_forms(case, interpret):
    hk, tb, occ, val, pm = (None if a is None else jnp.asarray(a)
                            for a in case)
    out = {"jax_ref": jax_ref(hk, tb, occ, val, pm)}
    if interpret:
        jkn.set_kernel_backend("interpret")
        try:
            out["jax_interpret"] = jkn.orbit_match(hk, tb, occ, val, pm)
        finally:
            jkn.set_kernel_backend(None)
    return {k: tuple(np.asarray(x) for x in v) for k, v in out.items()}


def port_args(case):
    hk, tb, occ, val, pm = case
    t = lambda a: None if a is None else torch.from_numpy(
        np.ascontiguousarray(a))
    return (t(hk.view(np.int32)), t(tb.view(np.int32)), t(occ), t(val),
            t(pm))


def port_forms(case):
    args = port_args(case)
    return {"dispatcher": kn.orbit_match(*args),
            "dispatcher_block_32": kn.orbit_match(*args, block_b=32),
            "ref": ref.orbit_match_ref(*args)}


def check(case, label, interpret=False):
    want = jax_forms(case, interpret)
    got = port_forms(case)
    for pname, outs in got.items():
        for jname, wants in want.items():
            for name, g, w in zip(("cidx", "hit", "valid_hit", "pop"), outs,
                                  wants):
                assert g.dtype == torch.int32, (pname, name)
                np.testing.assert_array_equal(
                    g.numpy(), w, err_msg=f"{label}: {name}, port {pname} "
                                          f"vs {jname}")
    return got["ref"]


@pytest.mark.parametrize("b,c", SWEEP)
def test_orbit_match_sweep(b, c):
    check(make_case(b + c, b, c, occ=np.random.default_rng(c).integers(
              0, 2, c), val=np.random.default_rng(b).integers(0, 2, c)),
          f"sweep b={b} c={c}", interpret=b * c <= 64 * 16)


@pytest.mark.parametrize("b,c", SWEEP)
@pytest.mark.parametrize("dup", [False, True], ids=["keys", "dup_entries"])
def test_orbit_match_flags_and_duplicates(b, c, dup):
    """Flags of -1, 0, 1 and 2 on the entries and the mask; repeated
    entries, occupied or not: the first occupied copy is ``cidx`` and
    ``pop`` counts every occupied copy."""
    case = make_case(7 * b + c, b, c, mask=True, dup=dup)
    check(case, f"flags b={b} c={c} dup={dup}", interpret=b * c <= 64 * 16)


def test_orbit_match_first_occupied_duplicate_wins():
    """One key three times: unoccupied (flag -1), occupied and invalid,
    occupied and valid.  ``cidx`` is the second entry, ``valid_hit`` is 0,
    and both occupied copies count toward ``pop``."""
    keys = np.array([4, 9, 9, 9, 2], np.int32)
    case = (hash128_u32_np(np.array([9, 2, 4, 5], np.int32)),
            hash128_u32_np(keys), np.array([1, -1, 2, 1, 0], np.int32),
            np.array([1, 1, -1, 1, 1], np.int32),
            np.array([1, 1, 2, 1], np.int32))
    cidx, hit, vhit, pop = check(case, "first occupied", interpret=True)
    assert cidx.tolist() == [2, -1, 0, -1]
    assert hit.tolist() == [1, 0, 1, 0] and vhit.tolist() == [0, 0, 1, 0]
    assert pop.tolist() == [1, 0, 1, 1, 0]


def test_orbit_match_property():
    """The reference's property (distinct keys, all occupied and valid):
    every hit indexes an entry of the lane's key, every miss is a key not
    in the table, and ``pop`` sums to the hits; over pinned seeds."""
    rng = np.random.default_rng(42)
    for i in range(15):
        b, c, universe = (int(rng.integers(1, 201)), int(rng.integers(1, 65)),
                          int(rng.integers(8, 65)))
        c = min(c, universe)
        keys = rng.choice(universe, c, replace=False).astype(np.int32)
        q = rng.integers(0, universe, b).astype(np.int32)
        case = (hash128_u32_np(q), hash128_u32_np(keys),
                np.ones(c, np.int32), np.ones(c, np.int32), None)
        cidx, hit, vhit, pop = check(case, f"property {i}",
                                     interpret=i == 0)
        for lane in range(b):
            if hit[lane]:
                assert keys[int(cidx[lane])] == q[lane]
            else:
                assert q[lane] not in set(keys.tolist())
        assert int(pop.sum()) == int(hit.sum())


def test_orbit_match_batch_not_block_multiple():
    mask = np.random.default_rng(3).integers(0, 2, 37).astype(np.int32)
    case = make_case(37, 37, 16, occ=np.ones(16, np.int32),
                     val=np.ones(16, np.int32))[:4] + (mask,)
    check(case, "b=37 mask", interpret=True)


def test_orbit_match_empty_table():
    """Nothing occupied: all misses, zero popularity."""
    b, c = 40, 8
    case = make_case(1, b, c, occ=np.zeros(c, np.int32),
                     val=np.ones(c, np.int32), universe=50)
    cidx, hit, vhit, pop = check(case, "empty table", interpret=True)
    assert cidx.tolist() == [-1] * b
    assert int(hit.sum()) == int(vhit.sum()) == int(pop.sum()) == 0


def test_orbit_match_all_invalid_entries():
    """Occupied but invalid: every lane hits, none is a valid hit."""
    b, c = 64, 8
    keys = np.arange(c, dtype=np.int32)
    q = np.random.default_rng(2).integers(0, c, b).astype(np.int32)
    case = (hash128_u32_np(q), hash128_u32_np(keys), np.ones(c, np.int32),
            np.zeros(c, np.int32), None)
    _, hit, vhit, _ = check(case, "all invalid", interpret=True)
    assert int(hit.sum()) == b and int(vhit.sum()) == 0


def test_orbit_match_mask_parity():
    """Masked popularity equals a hand count."""
    b, c = 48, 8
    keys = np.arange(c, dtype=np.int32)
    rng = np.random.default_rng(4)
    q = rng.integers(0, c, b).astype(np.int32)
    mask = rng.integers(0, 2, b).astype(np.int32)
    case = (hash128_u32_np(q), hash128_u32_np(keys), np.ones(c, np.int32),
            np.ones(c, np.int32), mask)
    _, _, _, pop = check(case, "mask", interpret=True)
    np.testing.assert_array_equal(pop.numpy(),
                                  np.bincount(q[mask > 0], minlength=c))


def test_cpu_wrapper_launches_nothing_and_empty_table_raises():
    """On CPU tensors the dispatcher runs the plain version and launches
    nothing; the wrapper, the kernel's only launch path, refuses them.  A
    table of no entries is refused, as the reference's ``argmax`` over an
    empty axis refuses it."""
    hk, tb, occ, val, pm = port_args(make_case(5, 30, 12, mask=True))
    kn.reset_launch_counts()
    got = kn.orbit_match(hk, tb, occ, val, pm)
    for g, w in zip(got, ref.orbit_match_ref(hk, tb, occ, val, pm)):
        assert torch.equal(g, w)
    assert kn.LAUNCHES["orbit_match"] == 0 and kn.CALLS["orbit_match"] == 1
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.orbit_match(hk, tb, occ, val, pm)
    assert kn.LAUNCHES["orbit_match"] == 0
    with pytest.raises(ValueError, match="at least one entry"):
        kn.orbit_match(hk, tb[:0], occ[:0], val[:0])


PAST_CLUSTER = CLUSTER_LANES + 1808       # 10,000 lanes
PAST_CHUNK = 2 * CHUNK + 808              # 9,000 entries, three passes


@pytest.mark.parametrize("mask,dup", [(False, False), (True, False),
                                      (True, True)],
                         ids=["all_lanes", "mask", "mask_dup_entries"])
def test_orbit_match_batch_past_one_cluster(mask, dup):
    """More lanes than one launch of the kernel covers at once (a cluster
    of 8 blocks of 1,024 threads), so its threads loop over lanes."""
    check(make_case(11, PAST_CLUSTER, 64, mask=mask, dup=dup),
          f"b={PAST_CLUSTER} mask={mask} dup={dup}")


@pytest.mark.parametrize("b,c", [(17, 5), (64, 16), (300, 128), (31, 130),
                                 (1024, 512)])
def test_orbit_match_duplicate_heavy_table(b, c):
    """A table of copies of four keys, occupied or not, a mask on the
    lanes: ``cidx`` is the first occupied copy, ``pop`` counts every
    occupied copy."""
    case = make_case(3 * b + c, b, c, mask=True, universe=4)
    _, hit, _, pop = check(case, f"four keys b={b} c={c}",
                           interpret=b * c <= 64 * 16)
    assert int(hit.sum()) > 0 and int(pop.sum()) > 0


@pytest.mark.parametrize("universe", [None, 4], ids=["keys", "four_keys"])
def test_orbit_match_table_past_one_chunk(universe):
    """More entries than the kernel stages at once (``kernel.CHUNK``), so
    it passes over the table three times: ``cidx`` is the first occupied
    match over all passes, ``pop`` counts the matches of every pass."""
    c = PAST_CHUNK
    case = make_case(5, 64, c, mask=True, universe=universe or 2 * c)
    _, hit, _, pop = check(case, f"c={c} universe={universe}")
    assert int(hit.sum()) > 0 and int(pop.sum()) > 0


@pytest.mark.cuda
def test_cuda_kernel_design_edges():
    """On the card: lanes past one cluster, tables past one chunk and
    tables of copies of four keys, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    cases = [(PAST_CLUSTER, 128, 50), (352, PAST_CHUNK, 2 * PAST_CHUNK),
             (PAST_CLUSTER, PAST_CHUNK, 4), (352, CHUNK, 4), (1025, 16, 4),
             (352, 128, 4), (31, 130, 4)]
    for i, (b, c, universe) in enumerate(cases):
        for mask in (False, True):
            args = [None if a is None else a.cuda() for a in port_args(
                make_case(i, b, c, mask=mask, universe=universe))]
            got = ops.orbit_match(*args)
            torch.cuda.synchronize()
            for g, w in zip(got, ref.orbit_match_ref(*args)):
                assert torch.equal(g, w), (b, c, universe, mask)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: the Hopper kernel equals the plain version exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    for i, (b, c) in enumerate(SWEEP + [(1, 1), (352, 128), (4096, 1024),
                                        (31, 130)]):
        for mask, dup in ((False, False), (True, True)):
            args = [None if a is None else a.cuda()
                    for a in port_args(make_case(i, b, c, mask=mask,
                                                 dup=dup))]
            before = kn.LAUNCHES["orbit_match"]
            got = ops.orbit_match(*args)
            torch.cuda.synchronize()
            assert kn.LAUNCHES["orbit_match"] == before + 1
            for g, w in zip(got, ref.orbit_match_ref(*args)):
                assert torch.equal(g, w), (b, c, mask, dup)
