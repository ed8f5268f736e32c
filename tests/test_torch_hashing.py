"""The port's hashing, value bytes and saturating counters against the
JAX reference, exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import hashing as jh  # noqa: E402
from repro.kvstore.store import synth_value as jax_synth_value  # noqa: E402

from repro_torch.core import hashing as th  # noqa: E402
from repro_torch.core.types import COUNTER_MAX, sat_add  # noqa: E402
from repro_torch.interop import to_numpy  # noqa: E402
from repro_torch.kvstore.store import synth_value  # noqa: E402

EDGES = np.array([0, -1, 2**31 - 1, -2**31, 1, 255, 256, 65535, 65536],
                 np.int32)


def ids(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGES, rng.integers(-2**31, 2**31, n,
                                               dtype=np.int64
                                               ).astype(np.int32)])


def test_hash128_matches_reference():
    k = ids()
    want = np.asarray(jh.hash128_u32(jnp.asarray(k)))
    got = to_numpy(th.hash128_u32(torch.from_numpy(k)), "hkey")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(th.hash128_u32_np(k), want)
    np.testing.assert_array_equal(jh.hash128_u32_np(k), want)


@pytest.mark.parametrize("n_srv", [1, 4, 32, 7])
def test_server_of_key_matches_reference(n_srv):
    k = ids(1)
    want = np.asarray(jh.server_of_key(jnp.asarray(k), n_srv))
    got = th.server_of_key(torch.from_numpy(k), n_srv).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_synth_value_matches_reference():
    rng = np.random.default_rng(2)
    k = ids(2, 256)
    v = rng.integers(0, 2**31 - 1, k.shape[0], dtype=np.int64).astype(np.int32)
    off = (rng.integers(0, 4, k.shape[0]) * 1438).astype(np.int32)
    want = np.asarray(jax_synth_value(jnp.asarray(k), jnp.asarray(v), 64,
                                      offset=jnp.asarray(off)))
    got = synth_value(torch.from_numpy(k), torch.from_numpy(v), 64,
                      offset=torch.from_numpy(off)).numpy()
    np.testing.assert_array_equal(got, want)
    want0 = np.asarray(jax_synth_value(jnp.asarray(k), jnp.asarray(v), 16))
    np.testing.assert_array_equal(
        synth_value(torch.from_numpy(k), torch.from_numpy(v), 16).numpy(),
        want0)


def test_sat_add_clamps_at_uint32_max():
    acc = torch.tensor([0, 5, COUNTER_MAX - 3, COUNTER_MAX], dtype=torch.int64)
    out = sat_add(acc, torch.tensor([7, 0, 10, 1], dtype=torch.int32))
    assert out.tolist() == [7, 5, COUNTER_MAX, COUNTER_MAX]
    assert sat_add(acc, 3).tolist() == [3, 8, COUNTER_MAX, COUNTER_MAX]
    assert to_numpy(out, "hits").dtype == np.uint32


@pytest.mark.parametrize("width", [2048, 64, 1000])
@pytest.mark.parametrize("salt", range(5))
def test_fold_hash_matches_reference(width, salt):
    """Random and edge key hashes (ids 0, -1, 2**31 - 1 among them) fold
    to the reference's columns, for power-of-two widths and one that is
    not (the unsigned ``%``), with every count-min salt."""
    hk = jh.hash128_u32(jnp.asarray(ids(3 + salt)))
    want = np.asarray(jh.fold_hash(hk, width, salt=salt))
    got = th.fold_hash(torch.from_numpy(np.asarray(hk).view(np.int32)),
                       width, salt=salt).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_fold_hash_shifts_are_logical():
    """Hash words with the top bit set: ``>> 7`` must not drag the sign
    in, and ``<< 3`` must drop the bits above 32."""
    words = np.array([[0x80000000, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF],
                      [0, 0, 0x80000001, 0xE0000000],
                      [0xDEADBEEF, 0x12345678, 0xF0F0F0F0, 0x1FFFFFFF]],
                     np.uint32)
    for salt in range(5):
        want = np.asarray(jh.fold_hash(jnp.asarray(words), 1000, salt=salt))
        got = th.fold_hash(torch.from_numpy(words.view(np.int32)), 1000,
                           salt=salt).numpy()
        np.testing.assert_array_equal(got, want)
