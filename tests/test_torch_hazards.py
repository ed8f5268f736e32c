"""Parity hazards between PyTorch and the JAX reference, pinned.

* The recirculation budget and serve interval are float32 expressions
  that feed an integer cast.  The reference runs compiled, and XLA folds
  their constants (``62 + key_size``, ``window * 1e-6 / subrounds``,
  ``1e6 / rate``); the port must reproduce the compiled values bit for bit.
* ``torch.log2`` and ``jnp.log2`` round differently for some float32
  inputs; the latency bucket may only differ next to a bucket edge, and
  it must not depend on the number of CPU threads.
* The port imports neither ``jax`` nor the reference package.
"""
import ast
import pathlib
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kvstore import client as jcl  # noqa: E402

from repro_torch.core.pipeline import recirc_budget  # noqa: E402
from repro_torch.kvstore import client as tcl  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference_budget(live, vlen, recirc_gbps, window_us, subrounds,
                      key_size):
    """``pipeline.window_pipeline.one_subround``'s budget lines, verbatim."""
    window = jnp.float32(window_us)
    nlive = jnp.maximum(jnp.sum(live.astype(jnp.int32)), 1)
    mean_line = (jnp.sum(jnp.where(live, vlen, 0)) / nlive + 62 + key_size)
    pps = (recirc_gbps * 1e9 / 8.0) / mean_line
    budget = (pps * window * 1e-6 / subrounds).astype(jnp.int32)
    interval_us = nlive.astype(jnp.float32) / pps * 1e6
    return budget, interval_us


@pytest.mark.parametrize("gbps,window,subrounds",
                         [(100.0, 100.0, 4), (150.0, 100.0, 3),
                          (0.05, 50.0, 7)])
def test_budget_matches_compiled_reference(gbps, window, subrounds):
    """10^5 (live, vlen) tables spanning mean line sizes: every budget and
    interval equals the compiled reference's, bit for bit."""
    rng = np.random.default_rng(subrounds)
    n, c = 100_000, 8
    live = rng.random((n, c)) < 0.6
    vlen = rng.integers(0, 1439, (n, c)).astype(np.int32)
    kw = dict(recirc_gbps=gbps, window_us=window, subrounds=subrounds,
              key_size=16)
    ref = jax.jit(jax.vmap(partial(_reference_budget, **kw)))
    b_ref, iv_ref = map(np.asarray, ref(live, vlen))
    b_t, iv_t = recirc_budget(torch.from_numpy(live), torch.from_numpy(vlen),
                              **kw)
    np.testing.assert_array_equal(b_t.numpy(), b_ref)
    np.testing.assert_array_equal(iv_t.numpy(), iv_ref)


def test_lat_bucket_differs_only_at_edges():
    rng = np.random.default_rng(0)
    lat = np.concatenate([
        (rng.random(500_000) * 5000).astype(np.float32),
        np.float32(0.25) * np.exp2(rng.integers(0, 80, 500_000) / 4.0
                                   ).astype(np.float32),
    ]).astype(np.float32)
    want = np.asarray(jax.jit(jcl.lat_bucket)(lat))
    got = tcl.lat_bucket(torch.from_numpy(lat)).numpy()
    assert got.dtype == want.dtype
    diff = got != want
    edges = np.float32(0.25) * np.exp2(np.arange(81) / 4.0).astype(np.float32)
    near = np.min(np.abs(lat[:, None] - edges[None, :]), axis=1) \
        <= 4 * np.spacing(lat)
    assert np.all(near[diff]), lat[diff & ~near][:10]
    print(f"lat_bucket: {int(diff.sum())} of {lat.size} latencies bucketed "
          f"differently, all within 4 ulp of an edge")


def test_lat_bucket_same_under_thread_counts():
    """The port's buckets of the 10^6 latencies above are identical under
    1, 2 and 6 CPU threads, and equal floor(4 * log2(x)) with the float32
    log2 correctly rounded (numpy's float64 log2, rounded once)."""
    rng = np.random.default_rng(0)
    lat = np.concatenate([
        (rng.random(500_000) * 5000).astype(np.float32),
        np.float32(0.25) * np.exp2(rng.integers(0, 80, 500_000) / 4.0
                                   ).astype(np.float32),
    ]).astype(np.float32)
    x = np.maximum(lat, np.float32(0.25)) / np.float32(0.25)
    want = np.clip((np.float32(4.0) * np.log2(x.astype(np.float64))
                    .astype(np.float32)).astype(np.int32), 0, 79)
    threads = torch.get_num_threads()
    try:
        for n in (1, 2, 6):
            torch.set_num_threads(n)
            got = tcl.lat_bucket(torch.from_numpy(lat)).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{n} threads")
    finally:
        torch.set_num_threads(threads)


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_composed.py",
              *sorted((ROOT / "examples").glob("*_torch.py"))]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: {mod}"
