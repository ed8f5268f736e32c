"""The port's count-min update + query against the JAX reference, exactly.

The JAX ``kernels.cms_update_query`` runs on its ``ref`` backend (the
tile-ordered gather/scatter oracle) over the whole sweep, and on its
``interpret`` backend (the Pallas kernel under the interpreter) over a
subset.  The port's dispatcher and both plain versions (the one-hot
transcription and the gather/scatter form) must give the same
sketch and the same estimates, for one sketch and for a leading axis of
sketches against a JAX ``vmap``, as the servers run it.  On a card, the
CUDA kernel must equal the plain version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import kernels as jkn  # noqa: E402
from repro.core.hashing import hash128_u32 as jax_hash  # noqa: E402

from repro_torch import kernels as kn  # noqa: E402
from repro_torch.kernels.cms import kernel as cms_kernel  # noqa: E402
from repro_torch.kernels.cms import ops, ref  # noqa: E402

BATCHES = (1, 7, 8, 45, 256, 257, 600)
WIDTHS = (64, 512)
DENSITIES = (0.0, 0.5, 1.0)
BLOCKS = (32, 256)          # explicit, and the reference's default


def make_case(seed, b, w, density, n=None, start=50, pattern=None,
              tile=None):
    """Key hashes (uint32, with repeated keys), an int32 mask and a
    nonzero starting sketch; ``n`` adds a leading sketch axis.
    ``pattern`` replaces the random mask: "tile_end" masks one lane, the
    last of the second tile of ``tile`` lanes (of the first where there is
    one), and "one_tile" every lane of that tile and no other."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2 * b + 4, b).astype(np.int32)
    hk = np.asarray(jax_hash(jnp.asarray(keys)))
    lead = () if n is None else (n,)
    mask = (rng.random(lead + (b,)) < density).astype(np.int32)
    counts = rng.integers(0, start + 1, lead + (5, w)).astype(np.int32)
    if pattern is not None:
        t0 = tile if b > tile else 0
        t1 = min(t0 + tile, b)
        mask[:] = 0
        if pattern == "tile_end":
            mask[..., t1 - 1] = 1
        else:
            mask[..., t0:t1] = 1
    return hk, mask, counts


# (b, w, density or mask pattern, block_b, n): the cases aimed at the
# kernel's list of masked lanes and its 16-byte copies: widths not a
# multiple of 4 (and 1,000), one lane past the rack's 1,408, one masked
# lane at the end of a tile, one tile wholly masked and the others not
TARGETED = ([(b, w, p, blk, n) for b in (257, 1409) for w in (1000, 2047)
             for p in (1 / 32, 1.0) for blk in (32, 256) for n in (None, 4)]
            + [(b, w, pat, blk, n) for pat in ("tile_end", "one_tile")
               for b in (7, 600, 1409) for w in (64, 2047)
               for blk in (32, 256) for n in (None, 4)])


def jax_cms(hk, mask, counts, block_b, backend):
    """The reference dispatcher on ``backend``; a leading sketch axis goes
    through ``jax.vmap`` as ``server.py`` runs it."""
    fn = lambda c, m: jkn.cms_update_query(jnp.asarray(hk), m, c,
                                           block_b=block_b)
    if counts.ndim == 3:
        fn = jax.vmap(fn)
    jkn.set_kernel_backend(backend)
    try:
        out = fn(jnp.asarray(counts), jnp.asarray(mask))
    finally:
        jkn.set_kernel_backend(None)
    return tuple(np.asarray(x) for x in out)


def port_forms(hk, mask, counts, block_b):
    """Every port form of the op on CPU tensors: name -> (counts', est)
    (the kernel's wrapper takes CUDA tensors only)."""
    hk_t = torch.from_numpy(hk.view(np.int32).copy())
    m_t, c_t = torch.from_numpy(mask), torch.from_numpy(counts)
    idx = ops.rows_for(hk_t, counts.shape[-1])
    tile = ops.tile_for(hk.shape[0], block_b)
    return {
        "dispatcher": kn.cms_update_query(hk_t, m_t, c_t, block_b=block_b),
        "fast": ref.cms_update_query_fast(idx, m_t, c_t, block_b=tile),
        "one_hot": ref.cms_update_query_ref(idx, m_t, c_t, block_b=tile),
    }


def check(hk, mask, counts, block_b, backend, label):
    want_c, want_e = jax_cms(hk, mask, counts, block_b, backend)
    for name, (got_c, got_e) in port_forms(hk, mask, counts,
                                           block_b).items():
        assert got_c.dtype == torch.int32 and got_e.dtype == torch.int32
        np.testing.assert_array_equal(got_c.numpy(), want_c,
                                      err_msg=f"{label} {name} counts")
        np.testing.assert_array_equal(got_e.numpy(), want_e,
                                      err_msg=f"{label} {name} est")


@pytest.mark.parametrize("block_b", BLOCKS)
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("b", BATCHES)
def test_cms_matches_jax_ref(b, w, density, block_b):
    hk, mask, counts = make_case(b * 7 + w, b, w, density)
    check(hk, mask, counts, block_b, "ref", f"b={b} w={w} p={density}")


@pytest.mark.parametrize("b,w,block_b", [(7, 64, 256), (45, 64, 32),
                                         (257, 64, 256), (600, 512, 256),
                                         (257, 512, 32)])
def test_cms_matches_jax_interpret(b, w, block_b):
    """The Pallas kernel itself, under the interpreter."""
    hk, mask, counts = make_case(b + w, b, w, 0.5)
    check(hk, mask, counts, block_b, "interpret", f"b={b} w={w}")


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("b,block_b", [(45, 32), (257, 256), (600, 32)])
def test_cms_server_axis_matches_jax_vmap(n, b, block_b):
    """A leading axis of sketches over one batch, each sketch with its own
    mask, equals the reference vmapped over the servers."""
    hk, mask, counts = make_case(n * 100 + b, b, 64, 0.5, n=n)
    check(hk, mask, counts, block_b, "ref", f"n={n} b={b}")


@pytest.mark.parametrize("b,w,p,block_b,n", TARGETED[::6])
def test_cms_targeted_matches_jax_ref(b, w, p, block_b, n):
    pat = p if isinstance(p, str) else None
    hk, mask, counts = make_case(b + w, b, w, 0.0 if pat else p, n=n,
                                 pattern=pat,
                                 tile=ops.tile_for(b, block_b))
    check(hk, mask, counts, block_b, "ref", f"b={b} w={w} p={p} n={n}")


def test_cms_server_axis_matches_jax_vmap_interpret():
    hk, mask, counts = make_case(9, 300, 64, 0.5, n=4)
    check(hk, mask, counts, 256, "interpret", "n=4 b=300")


def test_tile_order_changes_the_estimates():
    """The estimates depend on the tile (the reason the port keeps the
    reference's tile rule): a key repeated inside one tile sees none of
    its own arrivals, across tiles it sees the earlier ones."""
    hk, mask, counts = make_case(1, 64, 64, 1.0, start=0)
    _, e8 = port_forms(hk, mask, counts, 8)["fast"]
    _, e64 = port_forms(hk, mask, counts, 64)["fast"]
    assert int(e64.sum()) < int(e8.sum())
    assert ops.tile_for(1) == 8 and ops.tile_for(45) == 45
    assert ops.tile_for(1408) == 256 and ops.tile_for(600, 32) == 32


def test_wrapper_runs_plain_version_on_cpu():
    """On CPU tensors the dispatcher runs the plain version and launches
    nothing; the wrapper, the kernel's only launch path, refuses them."""
    hk, mask, counts = make_case(3, 45, 64, 0.5, n=4)
    kn.reset_launch_counts()
    forms = port_forms(hk, mask, counts, 256)
    for g, w in zip(forms["dispatcher"], forms["fast"]):
        assert torch.equal(g, w)
    assert kn.LAUNCHES["cms"] == 0 and kn.CALLS["cms"] == 1
    hk_t = torch.from_numpy(hk.view(np.int32).copy())
    idx = ops.rows_for(hk_t, counts.shape[-1])
    m_t, c_t = torch.from_numpy(mask), torch.from_numpy(counts)
    for p in (None, 4):
        with pytest.raises(ValueError, match="CUDA tensors"):
            ops.update_query(idx, m_t, c_t, 45, p)
    assert kn.LAUNCHES["cms"] == 0


def test_kernel_refuses_a_sketch_over_shared_memory():
    """A width whose sketch exceeds one block's shared memory is refused
    before anything is built or launched."""
    with pytest.raises(ValueError, match="shared memory"):
        cms_kernel.launch(0, 0, 1, 0, 0, 0, 0, 1, 8, 20_000, 8, 0)
    wmax = cms_kernel.max_width()
    with pytest.raises(ValueError, match="shared memory"):
        cms_kernel.launch(0, 0, 1, 0, 0, 0, 0, 1, 8, wmax + 1, 8, 0)
    assert cms_kernel.smem_bytes(wmax, 1) <= 232_448
    # the rack's sketches beside its whole batch, and the widest batch
    assert cms_kernel.unit_lanes(1408, 2048) >= 1408
    assert cms_kernel.smem_bytes(2048, 1408) <= 232_448
    assert cms_kernel.smem_bytes(2048, 100_000) <= 232_448


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: the Hopper kernel equals the plain version, exactly,
    including the rack's shape (32 sketches of [5, 2048], 1,408 lanes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    cases = [(b, w, p, blk, None) for b in BATCHES for w in WIDTHS
             for p in DENSITIES for blk in BLOCKS]
    cases += [(1408, 2048, 0.05, 256, 32), (257, 64, 0.5, 32, 4)]
    cases += TARGETED + [(1409, 2048, p, 256, n) for p in (1 / 32, 0.5)
                         for n in (None, 32)]
    # tiles longer than the kernel's list: past 4,096 lanes, and beside a
    # sketch that leaves room for 512 lanes only
    cases += [(5000, 64, 0.5, 5000, None), (1000, 10500, 0.5, 1000, 2),
              (1000, 10500, 0.5, 256, 2)]
    for i, (b, w, p, blk, n) in enumerate(cases):
        pat = p if isinstance(p, str) else None
        hk, mask, counts = make_case(i, b, w, 0.0 if pat else p, n=n,
                                     pattern=pat, tile=ops.tile_for(b, blk))
        hk_t = torch.from_numpy(hk.view(np.int32)).cuda()
        m_t, c_t = torch.from_numpy(mask).cuda(), \
            torch.from_numpy(counts).cuda()
        idx = ops.rows_for(hk_t, w)
        tile = ops.tile_for(b, blk)
        before = kn.LAUNCHES["cms"]
        got = ops.update_query(idx, m_t, c_t, tile)
        torch.cuda.synchronize()
        assert kn.LAUNCHES["cms"] == before + 1
        want = ref.cms_update_query_fast(idx, m_t, c_t, block_b=tile)
        for g, wt in zip(got, want):
            assert torch.equal(g, wt), (b, w, p, blk, n)


# ---- the fleet: P points' sketches in one batched op (one launch) -------
# which of the op's inputs every point shares (in_dims None)
CMS_SHARING = {"none": (), "hkey": (0,), "mask": (1,), "counts": (2,)}


def batched_cms_case(seed, p, b, w, n, shared):
    """``(hk uint32, mask, counts)`` stacked per point, or point 0's where
    ``shared``, and their in_dims."""
    per = [make_case(seed + i, b, w, 0.5, n=n) for i in range(p)]
    dims = tuple(None if k in shared else 0 for k in range(3))
    args = [per[0][k] if d is None else np.stack([x[k] for x in per])
            for k, d in enumerate(dims)]
    return args, dims


@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("sharing", list(CMS_SHARING))
def test_batched_cms_matches_plain_and_jax_vmap(p, sharing):
    """The dispatcher under ``torch.func.vmap`` (the batching rule: per
    point row indices, P x n sketches) and the points op called directly
    equal the plain version once per point and the reference vmapped over
    the points and the servers."""
    b, w, n, block_b = 257, 64, 4, 32
    (hk, mask, counts), dims = batched_cms_case(
        31 * p, p, b, w, n, CMS_SHARING[sharing])
    hk_t = torch.from_numpy(hk.view(np.int32).copy())
    m_t, c_t = torch.from_numpy(mask), torch.from_numpy(counts)
    got = torch.func.vmap(
        lambda h, m, c: kn.cms_update_query(h, m, c, block_b=block_b),
        in_dims=dims)(hk_t, m_t, c_t)
    tile = ops.tile_for(b, block_b)
    exp = lambda a, d: a if d is not None else a.expand((p,) + a.shape)
    idx = ops.rows_for(hk_t, w)
    direct = torch.ops.repro_torch.cms_update_query_points(
        [hk_t, exp(m_t, dims[1]), exp(c_t, dims[2])], p, [tile])
    pt = lambda a, d, i: a if d is None else a[i]
    for i in range(p):
        want = ref.cms_update_query_fast(pt(idx, dims[0], i),
                                         pt(m_t, dims[1], i),
                                         pt(c_t, dims[2], i), block_b=tile)
        for g, dr, wt in zip(got, direct, want):
            assert torch.equal(g[i], wt) and torch.equal(dr[i], wt), \
                (sharing, i)

    def one(h, c, m):
        return jax.vmap(lambda c1, m1: jkn.cms_update_query(
            h, m1, c1, block_b=block_b))(c, m)

    jkn.set_kernel_backend("ref")
    try:
        jwant = jax.vmap(one, in_axes=(dims[0], dims[2], dims[1]))(
            jnp.asarray(hk), jnp.asarray(counts), jnp.asarray(mask))
    finally:
        jkn.set_kernel_backend(None)
    for g, wt in zip(got, jwant):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wt),
                                      err_msg=f"p={p} sharing={sharing}")


@pytest.mark.cuda
def test_cuda_batched_kernel_matches_plain_version():
    """On the card: P = 1, 4 and 12 points of the rack's 32 sketches (and
    a small case), row indices per point or shared, in one launch, equal
    the plain version once per point, exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    for b, w, n, blk in ((257, 64, 4, 32), (1408, 2048, 32, 256)):
        for p in (1, 4, 12):
            for shared in ((), (0,)):
                (hk, mask, counts), dims = batched_cms_case(
                    p + b, p, b, w, n, shared)
                hk_t = torch.from_numpy(hk.view(np.int32).copy()).cuda()
                m_t = torch.from_numpy(mask).cuda()
                c_t = torch.from_numpy(counts).cuda()
                idx = ops.rows_for(hk_t, w)
                tile = ops.tile_for(b, blk)
                before = kn.LAUNCHES["cms"]
                got = ops.update_query(idx, m_t, c_t, tile, p)
                via = torch.func.vmap(
                    lambda h, m, c: kn.cms_update_query(h, m, c,
                                                        block_b=blk),
                    in_dims=dims)(hk_t, m_t, c_t)
                torch.cuda.synchronize()
                assert kn.LAUNCHES["cms"] == before + 2
                for i in range(p):
                    want = ref.cms_update_query_fast(
                        idx if shared else idx[i], m_t[i], c_t[i],
                        block_b=tile)
                    for g, v, wt in zip(got, via, want):
                        assert torch.equal(g[i], wt), (b, p, shared, i)
                        assert torch.equal(v[i], wt), (b, p, shared, i)
