"""The port's fused subround op against the JAX reference, exactly.

The port's ``subround_ref`` must equal the JAX ``subround_ref`` on all 32
outputs over the reference's fuzz cases, the kernel-test shapes and the
paper's shape.  On a card, the CUDA kernel must equal the port's plain
version on the same cases.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.subround.ops import SubroundOuts as RefOuts  # noqa: E402
from repro.kernels.subround.ref import subround_ref as jax_subround_ref  # noqa: E402
from test_parity_fuzz import (  # noqa: E402
    BASE_SEED, SUBROUND_SHAPES, _fuzz_subround_case)
from torch_parity import assert_trees_equal  # noqa: E402

from repro_torch.interop import from_numpy  # noqa: E402
from repro_torch.kernels.subround.ops import SubroundOuts  # noqa: E402
from repro_torch.kernels.subround.ops import subround as subround_op  # noqa: E402
from repro_torch.kernels.subround.ref import subround_ref  # noqa: E402

_ARG_NAMES = ("hkey", "want", "wreq", "inst", "frag", "nfrags", "kidx",
              "vlen", "client", "seq", "port", "ts", "hkeys", "occupied",
              "st_valid", "st_version", "rt_client", "rt_seq", "rt_port",
              "rt_ts", "rt_acked", "rt_kidx", "qlen", "front", "rear",
              "ob_live", "ob_kidx", "ob_version", "ob_vlen", "ob_frags",
              "budget")

# (b, c, s, f, j, budget): the kernel-test shapes of the reference
# (test_kernels.py) and the paper's shape (192 client + 16 CRN + 80 reply
# + 64 fetch lanes against C = 128 entries).
FIXED_SHAPES = ((24, 8, 4, 1, 4, 100), (64, 16, 8, 2, 8, 7),
                (17, 5, 3, 2, 4, 0), (300, 130, 8, 1, 8, 25),
                (352, 128, 8, 1, 8, 1000))


def case(seed, b, c, s, f, budget=None):
    """(jax args, numpy args) of one fuzz case; ``budget`` overrides."""
    rng = np.random.default_rng(seed)
    args = list(_fuzz_subround_case(rng, b, c, s, f))
    if budget is not None:
        args[-1] = jnp.int32(budget)
    return args, [np.asarray(a) for a in args]


# (b, c, s, f, j) of the cases aimed at the kernel's parallel admission and
# its match: one entry wanted by every lane, across every warp of the
# block (and, past 512 lanes, across its rounds), and duplicate occupied
# entries, which ``pop`` counts each and ``cidx`` takes the first of
TARGETED_SHAPES = ((33, 8, 4, 1, 4), (64, 16, 8, 4, 8), (352, 128, 8, 1, 8),
                   (1000, 128, 8, 1, 8), (4096, 128, 8, 1, 8))


def targeted_case(seed, b, c, s, f, one_key=False, dup=False, budget=None):
    """(jax args, numpy args) of a fuzz case reshaped: ``one_key`` makes
    every lane want entry 0, valid and occupied; ``dup`` copies the key of
    one entry onto another for a quarter of the entries, all occupied."""
    _, nargs = case(seed, b, c, s, f, budget)
    nargs = [np.array(a) for a in nargs]
    rng = np.random.default_rng(seed + 1)
    hk, want, thk, occ, stv = (nargs[i] for i in (0, 1, 12, 13, 14))
    if dup:
        n = max(1, c // 4)
        src, dst = rng.integers(0, c, n), rng.integers(0, c, n)
        thk[dst] = thk[src]
        occ[src], occ[dst] = 1, 1
    if one_key:
        hk[:] = thk[0]
        want[:] = 1
        occ[0], stv[0] = 1, 1
    return [jnp.asarray(a) for a in nargs], nargs


TARGETED = [(shp, kw) for shp in TARGETED_SHAPES[:4]
            for kw in (dict(one_key=True), dict(dup=True),
                       dict(one_key=True, dup=True))]


def to_port(np_args, device="cpu"):
    return [from_numpy(a, torch.device(device), n)
            for a, n in zip(np_args, _ARG_NAMES)]


_jax_ref = jax.jit(jax_subround_ref,
                   static_argnames=("queue_size", "max_frags", "max_serves"))


def check_against_jax(seed, b, c, s, f, j, budget=None, args=None):
    jargs, nargs = args or case(seed, b, c, s, f, budget)
    want = RefOuts(*_jax_ref(*jargs, queue_size=s, max_frags=f,
                             max_serves=j))
    got = SubroundOuts(*subround_ref(*to_port(nargs), queue_size=s,
                                     max_frags=f, max_serves=j))
    assert_trees_equal(got, want, f"subround seed={seed} b={b} c={c} s={s} "
                                  f"f={f} j={j}")


@pytest.mark.parametrize("i", range(20))
def test_subround_ref_matches_jax_fuzz(i):
    seed = BASE_SEED + i
    b, c, s, f, j, _ = SUBROUND_SHAPES[seed % len(SUBROUND_SHAPES)]
    check_against_jax(seed, b, c, s, f, j)


@pytest.mark.parametrize("b,c,s,f,j,budget", FIXED_SHAPES)
def test_subround_ref_matches_jax_shapes(b, c, s, f, j, budget):
    check_against_jax(7 * b + c, b, c, s, f, j, budget)


@pytest.mark.parametrize("shape,kw", TARGETED)
def test_subround_ref_matches_jax_targeted(shape, kw):
    b, c, s, f, j = shape
    seed = 11 * b + c
    check_against_jax(seed, b, c, s, f, j,
                      args=targeted_case(seed, b, c, s, f, **kw))


def test_targeted_cases_reach_their_edges():
    """The targeted cases do what they are for: every lane of a one-key
    case hits entry 0 and wants it, and a duplicate case's ``pop`` counts
    a lane once per occupied copy of its key."""
    b, c, s, f, j = TARGETED_SHAPES[2]
    _, nargs = targeted_case(3, b, c, s, f, one_key=True)
    out = SubroundOuts(*subround_ref(*to_port(nargs), queue_size=s,
                                     max_frags=f, max_serves=j))
    assert int(out.hit.sum()) == b and int(out.pop[0]) >= b
    assert int(out.accepted.sum()) + int(out.overflow.sum()) == b
    _, nargs = targeted_case(3, b, c, s, f, one_key=True, dup=True)
    out = SubroundOuts(*subround_ref(*to_port(nargs), queue_size=s,
                                     max_frags=f, max_serves=j))
    thk = nargs[12]
    copies = int((thk == thk[0]).all(axis=1).sum())
    assert copies >= 1 and int(out.pop.sum()) == b * copies


def test_wrapper_runs_plain_version_on_cpu():
    """On CPU tensors the dispatcher runs the plain version and launches
    nothing; the wrapper, the kernel's only launch path, refuses them."""
    from repro_torch import kernels as kn
    b, c, s, f, j, budget = FIXED_SHAPES[1]
    _, nargs = case(3, b, c, s, f, budget)
    args = to_port(nargs)
    kn.reset_launch_counts()
    got = kn.subround(*args, s, f, j)
    want = subround_ref(*args, queue_size=s, max_frags=f, max_serves=j)
    for name, g, w in zip(SubroundOuts._fields, got, want):
        assert torch.equal(g, w), name
    assert kn.LAUNCHES["subround"] == 0 and kn.CALLS["subround"] == 1
    with pytest.raises(ValueError, match="CUDA tensors"):
        subround_op(*args, s, f, j)
    with pytest.raises(ValueError, match="CUDA tensors"):
        subround_op(*args, s, f, j, p=1)
    assert kn.LAUNCHES["subround"] == 0


def test_cuda_backend_refuses_cpu_tensors():
    from repro_torch import kernels as kn
    b, c, s, f, j, budget = FIXED_SHAPES[0]
    _, nargs = case(5, b, c, s, f, budget)
    kn.set_kernel_backend("cuda")
    try:
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            kn.subround(*to_port(nargs), s, f, j)
    finally:
        kn.set_kernel_backend(None)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: the Hopper kernel equals the plain version, exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    from repro_torch import kernels as kn
    shapes = [sh[:5] + (None,) for sh in SUBROUND_SHAPES] + list(FIXED_SHAPES)
    cases = [(sh, case(100 + i, *sh[:4], sh[5])[1])
             for i, sh in enumerate(shapes * 4)]
    # the targeted cases, and B = 33, 1,000 and 4,096 with full queues
    cases += [(sh + (None,), targeted_case(200 + i, *sh[:4], **kw)[1])
              for i, sh in enumerate(TARGETED_SHAPES)
              for kw in (dict(one_key=True), dict(dup=True),
                         dict(one_key=True, dup=True))]
    for i, sh in enumerate(TARGETED_SHAPES):
        _, nargs = case(300 + i, *sh[:4], 3)
        nargs = [np.array(a) for a in nargs]
        nargs[22][:] = sh[2]                          # qlen: every queue full
        nargs[24][:] = nargs[23]                      # rear = front
        cases.append((sh + (3,), nargs))
    for (b, c, s, f, j, _), nargs in cases:
        args = to_port(nargs, "cuda")
        before = kn.LAUNCHES["subround"]
        got = subround_op(*args, s, f, j)
        torch.cuda.synchronize()
        assert kn.LAUNCHES["subround"] == before + 1
        want = subround_ref(*args, queue_size=s, max_frags=f, max_serves=j)
        for name, g, w in zip(SubroundOuts._fields, got, want):
            assert torch.equal(g.cpu(), w.cpu()), (name, b, c, s, f, j)


def test_kernel_refuses_shapes_over_shared_memory():
    """A shape whose tables exceed one block's shared memory is refused
    before anything is built or launched, with the limit in the message."""
    from repro_torch.kernels.subround import kernel
    with pytest.raises(ValueError, match="shared memory"):
        kernel.launch([], [], 1, 60_000, 128, 8, 1, 8, 0)
    assert kernel.smem_bytes(60_000, 128, 8, 1) > kernel.MAX_SMEM_BYTES
    for b in (352, 4096):          # the path's batch and the largest checked
        assert kernel.smem_bytes(b, 128, 8, 1) <= kernel.MAX_SMEM_BYTES


# ---- the fleet: one batched op (one launch) for P switch instances ------
# which arguments every point shares (in_dims None): none, the switch's
# tables, the ingress lanes, the budget
SHARING = {"none": (), "tables": tuple(range(12, 30)),
           "lanes": tuple(range(12)), "budget": (30,)}
BATCH_SHAPE = (48, 16, 8, 2, 8)


def batched_case(seed, p, b, c, s, f, shared):
    """P fuzz cases of one shape with the ``shared`` arguments point 0's:
    ``(numpy arguments, stacked or shared, and their in_dims)``."""
    per = [case(seed + i, b, c, s, f)[1] for i in range(p)]
    dims = [None if k in shared else 0 for k in range(31)]
    args = [per[0][k] if d is None else np.stack([x[k] for x in per])
            for k, d in enumerate(dims)]
    return args, dims


def point(args, dims, i):
    return [a if d is None else a[i] for a, d in zip(args, dims)]


@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("sharing", list(SHARING))
def test_batched_subround_matches_plain_and_jax_vmap(p, sharing):
    """The dispatcher under ``torch.func.vmap`` (the batching rule), and
    the points op called directly, equal the plain version once per point
    and the reference under ``jax.vmap``, shared inputs included."""
    from functools import partial

    from repro_torch import kernels as kn

    b, c, s, f, j = BATCH_SHAPE
    nargs, dims = batched_case(700 + p, p, b, c, s, f, SHARING[sharing])
    args = to_port(nargs)
    got = SubroundOuts(*torch.func.vmap(
        lambda *a: tuple(kn.subround(*a, s, f, j)), in_dims=tuple(dims))(
            *args))
    direct = torch.ops.repro_torch.subround_points(args, p, [s, f, j])
    for i in range(p):
        want = subround_ref(*point(args, dims, i), queue_size=s, max_frags=f,
                            max_serves=j)
        for name, g, d, w in zip(SubroundOuts._fields, got, direct, want):
            assert torch.equal(g[i], w) and torch.equal(d[i], w), \
                (sharing, i, name)
    jwant = jax.vmap(partial(jax_subround_ref, queue_size=s, max_frags=f,
                             max_serves=j), in_axes=tuple(dims))(
        *[jnp.asarray(a) for a in nargs])
    assert_trees_equal(got, RefOuts(*jwant), f"p={p} sharing={sharing}")


@pytest.mark.cuda
def test_cuda_batched_kernel_matches_plain_version():
    """On the card: one batched launch of P = 1, 4 and 12 switch instances
    (each sharing), directly and through vmap's rule, equals the plain
    version once per point, exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    from repro_torch import kernels as kn
    for shape in (BATCH_SHAPE, (352, 128, 8, 1, 8)):
        b, c, s, f, j = shape
        for p in (1, 4, 12):
            for k, shared in enumerate(SHARING.values()):
                nargs, dims = batched_case(50 * p + k, p, b, c, s, f, shared)
                args = to_port(nargs, "cuda")
                before = kn.LAUNCHES["subround"]
                got = subround_op(*args, s, f, j, p=p)
                via = torch.func.vmap(
                    lambda *a: tuple(kn.subround(*a, s, f, j)),
                    in_dims=tuple(dims))(*args)
                torch.cuda.synchronize()
                assert kn.LAUNCHES["subround"] == before + 2
                for i in range(p):
                    want = subround_ref(*point(args, dims, i), queue_size=s,
                                        max_frags=f, max_serves=j)
                    for name, g, v, w in zip(SubroundOuts._fields, got, via,
                                             want):
                        assert torch.equal(g[i], w), (shape, p, k, i, name)
                        assert torch.equal(v[i], w), (shape, p, k, i, name)
