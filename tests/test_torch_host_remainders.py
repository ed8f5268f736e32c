"""Host-side pieces of already ported files against the JAX reference,
exactly: the paper's production workloads A-E, the byte-accurate
``ByteStore``, the byte-string key hash, the numpy owner hash, and the
names the ``core`` and ``kvstore`` packages export."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as j_core  # noqa: E402
import repro.kvstore as j_kvstore  # noqa: E402
from repro.core import hashing as jh  # noqa: E402
from repro.kvstore import store as js  # noqa: E402
from repro.kvstore import workload as jw  # noqa: E402

import repro_torch.core as t_core  # noqa: E402
import repro_torch.kvstore as t_kvstore  # noqa: E402
from repro_torch.core import hashing as th  # noqa: E402
from repro_torch.kvstore import store as ts  # noqa: E402
from repro_torch.kvstore import workload as tw  # noqa: E402


@pytest.mark.parametrize("name", sorted(jw.PRODUCTION_WORKLOADS))
def test_production_workloads_match_reference(name):
    assert tw.PRODUCTION_WORKLOADS[name] == jw.PRODUCTION_WORKLOADS[name]
    assert dataclasses.asdict(tw.production_workload(name)) == \
        dataclasses.asdict(jw.production_workload(name))
    base = dict(num_keys=1000, zipf_alpha=0.9, seed=3, offered_rps=2e6)
    assert dataclasses.asdict(tw.production_workload(
        name, tw.WorkloadConfig(**base))) == dataclasses.asdict(
        jw.production_workload(name, jw.WorkloadConfig(**base)))


def byte_keys(seed, n):
    rng = np.random.default_rng(seed)
    return [b""] + [bytes(rng.integers(0, 256, rng.integers(1, 40),
                                       dtype=np.uint8)) for _ in range(n)]


def test_hash128_bytes_matches_reference():
    for key in byte_keys(0, 200):
        np.testing.assert_array_equal(th.hash128_bytes_np(key),
                                      jh.hash128_bytes_np(key))
        arr = np.frombuffer(key, np.uint8)
        np.testing.assert_array_equal(th.hash128_bytes_np(arr),
                                      jh.hash128_bytes_np(arr))
    # a key identity hashes as its 4 little-endian bytes
    k = np.random.default_rng(1).integers(-2**31, 2**31, 64).astype(np.int32)
    want = th.hash128_u32_np(k)
    for i, ki in enumerate(k):
        np.testing.assert_array_equal(
            th.hash128_bytes_np(int(ki).to_bytes(4, "little", signed=True)),
            want[i])


@pytest.mark.parametrize("n_srv", [1, 7, 32])
def test_server_of_key_np_matches_reference(n_srv):
    k = np.random.default_rng(n_srv).integers(-2**31, 2**31, 4096).astype(
        np.int32)
    got = th.server_of_key_np(k, n_srv)
    np.testing.assert_array_equal(got, jh.server_of_key_np(k, n_srv))
    np.testing.assert_array_equal(
        got, th.server_of_key(torch.from_numpy(k), n_srv).numpy())


def test_byte_store_matches_reference():
    ref, port = js.ByteStore(16, 48, 32), ts.ByteStore(16, 48, 32)
    rng = np.random.default_rng(2)
    keys = [k[:16] for k in byte_keys(3, 20)]
    for step in range(120):
        key = keys[rng.integers(len(keys))]
        val = bytes(rng.integers(0, 256, rng.integers(0, 49), dtype=np.uint8))
        assert port.put(key, val) == ref.put(key, val), step
    for f in ("keys", "klen", "vals", "vlen", "hkey", "version", "used"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f), f)
    assert len(port) == len(ref)
    for key in keys + [b"absent"]:
        assert port.get(key) == ref.get(key)
    for i in range(len(ref)):
        assert port.get_by_idx(i) == ref.get_by_idx(i)
    for bad in ((b"k" * 17, b""), (b"k", b"v" * 49)):
        with pytest.raises(ValueError):
            port.put(*bad)
    full = ts.ByteStore(4, 4, 2)
    full.put(b"a", b"1")
    full.put(b"b", b"2")
    with pytest.raises(RuntimeError):
        full.put(b"c", b"3")


@pytest.mark.parametrize("ref_pkg,port_pkg", [(j_core, t_core),
                                              (j_kvstore, t_kvstore)])
def test_package_exports_match_reference(ref_pkg, port_pkg):
    """Every name the reference package exports (its ``__init__``'s
    imports, not its submodules) is exported by the port's, from the
    port's module of the same name."""
    names = [n for n, v in vars(ref_pkg).items()
             if not n.startswith("_") and not isinstance(v, types.ModuleType)
             and n != "annotations"]
    assert len(names) > 5
    for n in names:
        ref_obj, port_obj = getattr(ref_pkg, n), getattr(port_pkg, n)
        mod = getattr(ref_obj, "__module__", None)
        if mod and mod.startswith("repro."):
            assert port_obj.__module__.replace("repro_torch.", "repro.") \
                == mod, n
