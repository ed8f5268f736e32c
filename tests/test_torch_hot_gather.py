"""The port's hot_gather against the JAX reference.

``out[b] = sum_c [ids[b] == hot[c]] * rows[c]`` over every match, and
``hit[b]`` = any match.  int32 rows (the controller's path) must equal the
JAX ``hot_gather_ref`` and the Pallas kernel under the interpreter
exactly, with repeated hot ids and the sentinels (-1 and -2 among the hot
ids, -3 among the ids, as the controller uses them).
float32 rows must be exact where the hot ids are distinct (one term per
output), and within rtol 1e-6 where they repeat: a float sum over several
matches depends on its order, and XLA's dot and PyTorch's sum differ in
it.  bf16 rows must be within rtol = atol = 2e-2, the bound
``tests/test_kernels.py`` holds the reference's own kernel to: the two
packages round a bf16 sum at other places.  On a card, the CUDA kernel
must equal the plain version (bf16: within the same bound).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import kernels as jkn  # noqa: E402
from repro.kernels.hot_gather.ref import hot_gather_ref as jax_ref  # noqa: E402

from repro_torch import kernels as kn  # noqa: E402
from repro_torch.kernels.hot_gather import ops, ref  # noqa: E402
from repro_torch.kernels.hot_gather.kernel import CHUNK  # noqa: E402

SIZES = [(b, c, d) for b in (1, 128, 300) for c in (1, 128, 200)
         for d in (1, 3, 64)]


def make_case(seed, b, c, d, dtype, distinct):
    """ids with misses and sentinels, hot ids (repeated unless
    ``distinct``) with sentinels, rows of ``dtype``."""
    rng = np.random.default_rng(seed)
    universe = 2 * c + 4
    if distinct:
        hot = rng.choice(universe, c, replace=False).astype(np.int32)
        hot[rng.integers(0, c)] = -2           # one sentinel lane
    else:
        hot = rng.integers(0, max(2, c // 3), c).astype(np.int32)
        hot[rng.random(c) < 0.1] = -2
        hot[rng.random(c) < 0.05] = -1
    # ids never carry -1: the reference's wrapper pads the hot ids with -1
    # (and the ids with -2), so an id of -1 would match its padding; the
    # controller's ids use -3
    ids = rng.integers(0, universe, b).astype(np.int32)
    ids[rng.random(b) < 0.1] = -3
    if dtype == np.int32:
        rows = rng.integers(-1000, 1000, (c, d)).astype(np.int32)
    else:
        rows = rng.normal(size=(c, d)).astype(np.float32)
    return ids, hot, rows


def jax_forms(ids, hot, rows):
    """The JAX oracle, and the Pallas kernel under the interpreter."""
    out = {"jax_ref": jax_ref(jnp.asarray(ids), jnp.asarray(hot),
                              jnp.asarray(rows))}
    jkn.set_kernel_backend("interpret")
    try:
        out["jax_interpret"] = jkn.hot_gather(
            jnp.asarray(ids), jnp.asarray(hot), jnp.asarray(rows))
    finally:
        jkn.set_kernel_backend(None)
    return {k: tuple(np.asarray(x) for x in v) for k, v in out.items()}


def port_forms(ids, hot, rows):
    """The port's forms on CPU tensors (the kernel's wrapper takes CUDA
    tensors only)."""
    t = lambda a: torch.from_numpy(a)
    return {"dispatcher": kn.hot_gather(t(ids), t(hot), t(rows)),
            "ref": ref.hot_gather_ref(t(ids), t(hot), t(rows))}


def check(ids, hot, rows, exact, label, interpret=True):
    want = jax_forms(ids, hot, rows) if interpret else {
        "jax_ref": tuple(np.asarray(x) for x in jax_ref(
            jnp.asarray(ids), jnp.asarray(hot), jnp.asarray(rows)))}
    for pname, (g_out, g_hit) in port_forms(ids, hot, rows).items():
        assert g_out.dtype == torch.from_numpy(rows).dtype
        assert g_hit.dtype == torch.int32
        for jname, (w_out, w_hit) in want.items():
            msg = f"{label}: port {pname} vs {jname}"
            np.testing.assert_array_equal(g_hit.numpy(), w_hit, err_msg=msg)
            if exact:
                np.testing.assert_array_equal(g_out.numpy(), w_out,
                                              err_msg=msg)
            else:
                np.testing.assert_allclose(g_out.numpy(), w_out, rtol=1e-6,
                                           atol=1e-6, err_msg=msg)


@pytest.mark.parametrize("b,c,d", SIZES)
def test_int32_rows_repeated_hot_ids_exact(b, c, d):
    ids, hot, rows = make_case(b + 3 * c + 7 * d, b, c, d, np.int32, False)
    check(ids, hot, rows, True, f"int32 b={b} c={c} d={d}",
          interpret=d == 1 or b == 300)


BF16_TOL = 2e-2


@pytest.mark.parametrize("b,c,d", SIZES)
@pytest.mark.parametrize("distinct", [True, False], ids=["distinct",
                                                         "repeated"])
def test_bf16_rows(b, c, d, distinct):
    """bf16 rows (float32 normals rounded to bf16 the same way in both
    packages): the port's two forms against the JAX oracle, and against
    the Pallas kernel under the interpreter on a subset."""
    ids, hot, rows = make_case(11 * b + c + d, b, c, d, np.float32, distinct)
    jrows = jnp.asarray(rows, jnp.bfloat16)
    want = {"jax_ref": jax_ref(jnp.asarray(ids), jnp.asarray(hot), jrows)}
    if d == 1 and distinct:
        jkn.set_kernel_backend("interpret")
        try:
            want["jax_interpret"] = jkn.hot_gather(
                jnp.asarray(ids), jnp.asarray(hot), jrows)
        finally:
            jkn.set_kernel_backend(None)
    t = torch.from_numpy
    trows = t(rows).to(torch.bfloat16)
    got = {"dispatcher": kn.hot_gather(t(ids), t(hot), trows),
           "ref": ref.hot_gather_ref(t(ids), t(hot), trows)}
    for pname, (g_out, g_hit) in got.items():
        assert g_out.dtype == torch.bfloat16 and g_hit.dtype == torch.int32
        for jname, (w_out, w_hit) in want.items():
            msg = f"bf16 b={b} c={c} d={d}: port {pname} vs {jname}"
            np.testing.assert_array_equal(g_hit.numpy(), np.asarray(w_hit),
                                          err_msg=msg)
            np.testing.assert_allclose(g_out.float().numpy(),
                                       np.asarray(w_out, np.float32),
                                       rtol=BF16_TOL, atol=BF16_TOL,
                                       err_msg=msg)


@pytest.mark.parametrize("b,c,d", SIZES)
def test_float32_rows(b, c, d):
    seed = 5 * b + c + d
    ids, hot, rows = make_case(seed, b, c, d, np.float32, True)
    check(ids, hot, rows, True, f"f32 distinct b={b} c={c} d={d}",
          interpret=d == 1)
    ids, hot, rows = make_case(seed, b, c, d, np.float32, False)
    check(ids, hot, rows, False, f"f32 repeated b={b} c={c} d={d}",
          interpret=False)


def test_controller_shapes_and_sentinels():
    """The controller's three calls: ids [128] against hot [2048], ids
    [2048] against hot [2048], and ids [2048] against hot [128] (hit
    only); report lanes repeat keys across servers."""
    rng = np.random.default_rng(0)
    report = rng.integers(0, 400, 2048).astype(np.int32)
    report[rng.random(2048) < 0.2] = -1
    est = np.where(report >= 0, rng.integers(0, 5000, 2048), 0
                   ).astype(np.int32)[:, None]
    cached = rng.choice(800, 128, replace=False).astype(np.int32)
    cached[rng.random(128) < 0.2] = -1
    hot_report = np.where(report >= 0, report, -2).astype(np.int32)
    ids_report = np.where(report >= 0, report, -3).astype(np.int32)
    ids_cached = np.where(cached >= 0, cached, -3).astype(np.int32)
    hot_cached = np.where(cached >= 0, cached, -2).astype(np.int32)
    zeros = np.zeros((128, 1), np.int32)
    for ids, hot, rows in ((ids_cached, hot_report, est),
                           (ids_report, hot_report, est),
                           (ids_report, hot_cached, zeros)):
        check(ids, hot, rows, True, f"controller {ids.shape}x{hot.shape}")


def test_wrapper_runs_plain_version_on_cpu():
    """On CPU tensors the dispatcher runs the plain version and launches
    nothing; the wrapper, the kernel's only launch path, refuses them."""
    ids, hot, rows = make_case(1, 30, 20, 1, np.int32, False)
    kn.reset_launch_counts()
    forms = port_forms(ids, hot, rows)
    for g, w in zip(forms["dispatcher"], forms["ref"]):
        assert torch.equal(g, w)
    assert kn.LAUNCHES["hot_gather"] == 0 and kn.CALLS["hot_gather"] == 1
    t = [torch.from_numpy(a) for a in (ids, hot, rows)]
    for p in (None, 1):
        with pytest.raises(ValueError, match="CUDA tensors"):
            ops.hot_gather(*t, p=p)
    assert kn.LAUNCHES["hot_gather"] == 0


def make_edge_case(seed, b, c, d, dtype, kind):
    """The hot vectors the kernel's table is aimed at: "sentinel90" and
    "sentinel100" make 90 % or all of the hot ids -2 (some ids ask for -2
    as well), "equal" makes them one id that half the lanes ask for,
    "multi" draws them from c // 8 ids, several matches a lane."""
    rng = np.random.default_rng(seed)
    universe = 2 * c + 4
    ids = rng.integers(0, universe, b).astype(np.int32)
    ids[rng.random(b) < 0.1] = -3
    if kind.startswith("sentinel"):
        share = 0.9 if kind == "sentinel90" else 1.0
        hot = rng.choice(universe, c, replace=False).astype(np.int32)
        hot[rng.permutation(c)[:int(round(share * c))]] = -2
        ids[rng.random(b) < 0.05] = -2
    elif kind == "equal":
        hot = np.full(c, 7, np.int32)
        ids[rng.random(b) < 0.5] = 7
    else:
        hot = rng.integers(0, max(1, c // 8), c).astype(np.int32)
        ids = rng.integers(0, max(1, c // 8) + 1, b).astype(np.int32)
    if dtype == np.int32:
        rows = rng.integers(-1000, 1000, (c, d)).astype(np.int32)
    else:
        rows = rng.normal(size=(c, d)).astype(np.float32)
    return ids, hot, rows


@pytest.mark.parametrize("b,c", [(128, 2048), (300, 200)])
@pytest.mark.parametrize("kind", ["sentinel90", "sentinel100"])
def test_sentinel_dense_hot_ids(b, c, kind):
    """Hot vectors dense in the -2 sentinel (the controller's report
    lanes), with some ids asking for -2: int32 rows exactly."""
    ids, hot, rows = make_edge_case(b + c, b, c, 1, np.int32, kind)
    assert (hot == -2).mean() > 0.89 and (ids == -2).any()
    check(ids, hot, rows, True, f"{kind} b={b} c={c}", interpret=c <= 200)


@pytest.mark.parametrize("b,c", [(128, 2048), (300, 200)])
@pytest.mark.parametrize("dtype", ["int32", "bf16"])
def test_all_hot_ids_equal(b, c, dtype):
    """Every hot id the same: a lane asking for it sums all C rows (int32
    exactly, bf16 within 2e-2); the rest miss."""
    ids, hot, rows = make_edge_case(2 * b + c, b, c, 1,
                                    np.int32 if dtype == "int32"
                                    else np.float32, "equal")
    if dtype == "int32":
        check(ids, hot, rows, True, f"equal b={b} c={c}", interpret=False)
        return
    jrows = jnp.asarray(rows, jnp.bfloat16)
    w_out, w_hit = jax_ref(jnp.asarray(ids), jnp.asarray(hot), jrows)
    t = torch.from_numpy
    trows = t(rows).to(torch.bfloat16)
    for g_out, g_hit in (kn.hot_gather(t(ids), t(hot), trows),
                         ref.hot_gather_ref(t(ids), t(hot), trows)):
        np.testing.assert_array_equal(g_hit.numpy(), np.asarray(w_hit))
        np.testing.assert_allclose(g_out.float().numpy(),
                                   np.asarray(w_out, np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("b,c", [(128, 200), (300, 128), (64, 2048)])
def test_float32_several_matches_d64(b, c):
    """float32 rows of width 64, hot ids drawn from c // 8 ids: several
    matches a lane, within the float32 bound of ``test_float32_rows``."""
    ids, hot, rows = make_edge_case(3 * b + c, b, c, 64, np.float32,
                                    "multi")
    eq = ids[:, None] == hot[None, :]
    assert eq.sum(axis=1).max() >= 4
    check(ids, hot, rows, False, f"f32 multi b={b} c={c}", interpret=False)


PAST_CHUNK = 2 * CHUNK + 808     # 9,000 hot ids: three of the kernel's tables


@pytest.mark.parametrize("kind,dtype", [("multi", np.float32),
                                        ("equal", np.int32),
                                        ("sentinel90", np.int32)],
                         ids=["f32_multi", "int32_equal", "int32_sentinel90"])
def test_hot_ids_past_one_chunk(kind, dtype):
    """More hot ids than one of the kernel's shared-memory tables holds
    (``kernel.CHUNK``): the matches of a lane fall in several tables and
    must still sum in ascending c (float32 within 1e-6, int32 exactly)."""
    b, c = 300, PAST_CHUNK
    ids, hot, rows = make_edge_case(7 * b + c, b, c, 3, dtype, kind)
    eq = ids[:, None] == hot[None, :]
    assert (eq[:, :CHUNK].any(axis=1) & eq[:, CHUNK:].any(axis=1)).any() \
        or kind == "sentinel90"
    check(ids, hot, rows, dtype == np.int32, f"{kind} c={c}",
          interpret=False)


EDGE_CASES = ([(b, c, 1, dt, kind) for b, c in ((1, 1), (300, 200),
                                                  (128, 2048), (2048, 2048),
                                                  (2048, 128))
               for kind in ("sentinel90", "sentinel100", "equal")
               for dt in (np.int32, "bf16")]
              + [(b, c, 64, dt, "multi") for b, c in ((128, 200), (300, 2048))
                 for dt in (np.float32, np.int32, "bf16")]
              + [(300, PAST_CHUNK, 3, np.float32, "multi"),
                 (2048, PAST_CHUNK, 1, np.int32, "equal"),
                 (2048, PAST_CHUNK, 1, "bf16", "sentinel90")])


@pytest.mark.cuda
def test_cuda_kernel_hash_table_edges():
    """On the card, the cases above through the kernel against the plain
    version: int32 exactly, float32 within 1e-6, bf16 within 2e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    for i, (b, c, d, dt, kind) in enumerate(EDGE_CASES):
        ids, hot, rows = (torch.from_numpy(a).cuda() for a in make_edge_case(
            i, b, c, d, np.int32 if dt == np.int32 else np.float32, kind))
        if dt == "bf16":
            rows = rows.to(torch.bfloat16)
        g_out, g_hit = ops.hot_gather(ids, hot, rows)
        w_out, w_hit = ref.hot_gather_ref(ids, hot, rows)
        torch.cuda.synchronize()
        assert torch.equal(g_hit, w_hit), (b, c, d, dt, kind)
        if dt == np.int32:
            assert torch.equal(g_out, w_out), (b, c, d, dt, kind)
        else:
            tol = BF16_TOL if dt == "bf16" else 1e-6
            torch.testing.assert_close(g_out.float(), w_out.float(),
                                       rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: the Hopper kernel equals the plain version; int32
    exactly, float32 exactly for distinct hot ids, else within 1e-6, bf16
    within 2e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    for i, (b, c, d) in enumerate(SIZES + [(2048, 2048, 1), (128, 2048, 1),
                                           (2048, 128, 1)]):
        for dtype, distinct, bf16 in (
                (np.int32, False, False), (np.float32, True, False),
                (np.float32, False, False), (np.float32, True, True),
                (np.float32, False, True)):
            ids, hot, rows = (torch.from_numpy(a).cuda() for a in make_case(
                i, b, c, d, dtype, distinct))
            if bf16:
                rows = rows.to(torch.bfloat16)
            before = kn.LAUNCHES["hot_gather"]
            g_out, g_hit = ops.hot_gather(ids, hot, rows)
            torch.cuda.synchronize()
            assert kn.LAUNCHES["hot_gather"] == before + 1
            w_out, w_hit = ref.hot_gather_ref(ids, hot, rows)
            assert torch.equal(g_hit, w_hit), (b, c, d, dtype)
            if bf16:
                torch.testing.assert_close(g_out.float(), w_out.float(),
                                           rtol=BF16_TOL, atol=BF16_TOL)
            elif dtype == np.int32 or distinct:
                assert torch.equal(g_out, w_out), (b, c, d, dtype)
            else:
                torch.testing.assert_close(g_out, w_out, rtol=1e-6,
                                           atol=1e-6)


# ---- the fleet: P controllers' merges in one batched op (grid z = P) ----
HG_SHARING = {"none": (), "ids": (0,), "hot": (1,), "rows": (2,)}


def batched_hg_case(seed, p, b, c, d, dtype, distinct, shared):
    per = [make_case(seed + i, b, c, d, dtype, distinct) for i in range(p)]
    dims = tuple(None if k in shared else 0 for k in range(3))
    args = [per[0][k] if dm is None else np.stack([x[k] for x in per])
            for k, dm in enumerate(dims)]
    return args, dims


@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("sharing", list(HG_SHARING))
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_batched_hot_gather_matches_plain_and_jax_vmap(p, sharing, dtype):
    """The dispatcher under ``torch.func.vmap`` (the batching rule) and
    the points op called directly equal the plain version once per point
    and the reference under ``jax.vmap``; the zero rows that the
    controller's third call shares between the points are the ``rows``
    case."""
    b, c, d = 128, 200, 1
    args, dims = batched_hg_case(17 * p, p, b, c, d, dtype, True,
                                 HG_SHARING[sharing])
    t = [torch.from_numpy(a) for a in args]
    got = torch.func.vmap(kn.hot_gather, in_dims=dims)(*t)
    direct = torch.ops.repro_torch.hot_gather_points(t, p, [])
    for i in range(p):
        want = ref.hot_gather_ref(*(a if dm is None else a[i]
                                    for a, dm in zip(t, dims)))
        for g, dr, w in zip(got, direct, want):
            assert torch.equal(g[i], w) and torch.equal(dr[i], w), \
                (sharing, i)
    jwant = jax.vmap(jax_ref, in_axes=dims)(*(jnp.asarray(a) for a in args))
    for g, w in zip(got, jwant):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"p={p} sharing={sharing}")


@pytest.mark.cuda
def test_cuda_batched_kernel_matches_plain_version():
    """On the card: P = 1, 4 and 12 points at the controller's three call
    shapes, each input stacked or shared, in one launch, equal the plain
    version once per point (int32 exactly, float32 with distinct hot ids
    exactly)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    for b, c, d in ((128, 2048, 1), (2048, 2048, 1), (2048, 128, 1),
                    (300, 200, 3)):
        for p in (1, 4, 12):
            for k, shared in enumerate(HG_SHARING.values()):
                for dtype in (np.int32, np.float32):
                    args, dims = batched_hg_case(p + k + b, p, b, c, d,
                                                 dtype, True, shared)
                    t = [torch.from_numpy(a).cuda() for a in args]
                    before = kn.LAUNCHES["hot_gather"]
                    got = ops.hot_gather(*t, p=p)
                    via = torch.func.vmap(kn.hot_gather, in_dims=dims)(*t)
                    torch.cuda.synchronize()
                    assert kn.LAUNCHES["hot_gather"] == before + 2
                    for i in range(p):
                        want = ref.hot_gather_ref(*(
                            a if dm is None else a[i]
                            for a, dm in zip(t, dims)))
                        for g, v, w in zip(got, via, want):
                            assert torch.equal(g[i], w), (b, c, p, k, i)
                            assert torch.equal(v[i], w), (b, c, p, k, i)
