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


def to_port(np_args, device="cpu"):
    return [from_numpy(a, torch.device(device), n)
            for a, n in zip(np_args, _ARG_NAMES)]


_jax_ref = jax.jit(jax_subround_ref,
                   static_argnames=("queue_size", "max_frags", "max_serves"))


def check_against_jax(seed, b, c, s, f, j, budget=None):
    jargs, nargs = case(seed, b, c, s, f, budget)
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


def test_wrapper_runs_plain_version_on_cpu():
    """On CPU tensors the wrapper is the plain version, kernel untouched."""
    from repro_torch import kernels as kn
    b, c, s, f, j, budget = FIXED_SHAPES[1]
    _, nargs = case(3, b, c, s, f, budget)
    args = to_port(nargs)
    kn.reset_launch_counts()
    got = subround_op(*args, s, f, j)
    want = subround_ref(*args, queue_size=s, max_frags=f, max_serves=j)
    for name, g, w in zip(SubroundOuts._fields, got, want):
        assert torch.equal(g, w), name
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
    for i, (b, c, s, f, j, budget) in enumerate(shapes * 4):
        _, nargs = case(100 + i, b, c, s, f, budget)
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
        kernel.launch([], 60_000, 128, 8, 1, 8, 0)
    assert kernel.smem_bytes(352, 128, 8, 1) <= kernel.MAX_SMEM_BYTES
