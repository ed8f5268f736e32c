"""The port's op-trace analyzer (``repro_torch.launch.hlo_analysis``), the
twin of ``tests/test_hlo_analysis.py``: exact on loop-free programs
(against ``torch.utils.flop_counter.FlopCounterMode``), exact scaling
over (nested) Python loops, HBM bytes that grow with the loop, and dot
FLOPs equal to the reference analyzer's on the compiled JAX version of
the same functions.  The collective wire rule equals the reference's
``_collective_wire`` on the same bytes and group size.  Everything is
exact: counts of shapes, on ``meta`` tensors.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.launch import hlo_analysis as j_hlo  # noqa: E402

from repro_torch.launch import hlo_analysis as hlo  # noqa: E402

N = 256
MM = 2 * N ** 3


def _x():
    return torch.empty(N, N, device="meta"), torch.empty(N, N, device="meta")


def _loop(n):
    def f(x, w):
        for _ in range(n):
            x = torch.tanh(x @ w)
        return x
    return f


def _nested(x, w):
    for _ in range(7):
        for _ in range(5):
            x = torch.tanh(x @ w)
    return x


def _two(x, w):
    return (x @ w) @ w


def _j_scan(n):
    def f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, None, length=n)[0]
    return f


def _j_nested(x, w):
    def outer(c, _):
        def inner(c2, _):
            return jnp.tanh(c2 @ w), None
        return jax.lax.scan(inner, c, None, length=5)[0], None
    return jax.lax.scan(outer, x, None, length=7)[0]


def _j_flops(fn):
    x = jax.ShapeDtypeStruct((N, N), jnp.float32)
    return j_hlo.analyze(jax.jit(fn).lower(x, x).compile().as_text()).flops


def test_loop_free_matches_flop_counter():
    a = hlo.analyze(_two, *_x())
    with FlopCounterMode(display=False) as fc:
        _two(*_x())
    assert a.flops == fc.get_total_flops() == 2 * MM


@pytest.mark.parametrize("n", [2, 10, 37])
def test_loop_trip_scaling(n):
    assert hlo.analyze(_loop(n), *_x()).flops == MM * n


def test_nested_loops():
    assert hlo.analyze(_nested, *_x()).flops == MM * 35


def test_hbm_bytes_nonzero_and_scaled():
    a1 = hlo.analyze(_loop(2), *_x())
    a2 = hlo.analyze(_loop(20), *_x())
    assert a1.hbm_bytes > 0
    assert a2.hbm_bytes > 5 * a1.hbm_bytes


@pytest.mark.parametrize("case", ["loop_free", "scan2", "scan10", "scan37",
                                  "nested"])
def test_dot_flops_match_reference(case):
    port, ref = {"loop_free": (_two, _two),
                 "scan2": (_loop(2), _j_scan(2)),
                 "scan10": (_loop(10), _j_scan(10)),
                 "scan37": (_loop(37), _j_scan(37)),
                 "nested": (_nested, _j_nested)}[case]
    assert hlo.analyze(port, *_x()).flops == _j_flops(ref)


def test_bmm_addmm_and_peak_bytes():
    """``einsum`` (bmm), ``linear`` (addmm) and the live-storage peak."""
    q = torch.empty(4, 8, 16, device="meta")
    k = torch.empty(4, 32, 16, device="meta")
    w = torch.empty(24, 16, device="meta")
    b = torch.empty(24, device="meta")

    def f(q, k, w, b):
        s = torch.einsum("bsd,btd->bst", q, k)            # 2*4*8*32*16
        return torch.nn.functional.linear(q.reshape(32, 16), w, b), s
    with hlo.OpTrace() as tr:
        f(q, k, w, b)
    assert tr.analysis.flops == 2 * 4 * 8 * 32 * 16 + 2 * 32 * 24 * 16
    # both results alive at the end: [32, 24] and [4, 8, 32] float32
    assert tr.peak_bytes >= 4 * (32 * 24 + 4 * 8 * 32)


def test_top_contributors_ranks_by_bytes():
    big = torch.empty(64, 512, device="meta")
    small = torch.empty(8, 8, device="meta")

    def f(a, b):
        for _ in range(3):
            a = a * 2
        return a, b + 1
    colls, hbm = hlo.top_contributors(f, big, small, n=4)
    assert colls == []
    assert hbm[0]["op"] == "aten.mul.Tensor" and hbm[0]["mult"] == 3
    assert hbm[0]["total"] == 3 * 64 * 512 * 4
    assert hbm[-1]["bytes"] == 8 * 8 * 4


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all"])
@pytest.mark.parametrize("g", [1, 2, 16])
def test_collective_wire_matches_reference(kind, g):
    out_b = 4096 * 4
    groups = "{{" + ",".join(map(str, range(g))) + "}}"
    inst = j_hlo.Instruction("x", "f32[4096]", kind,
                             f"%a), replica_groups={groups}")
    want = j_hlo._collective_wire(kind, inst, j_hlo.Computation("c"), 256)
    assert hlo._collective_wire(kind, out_b, g) == want
