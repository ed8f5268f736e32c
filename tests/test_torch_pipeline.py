"""The port's window pipeline against the JAX reference, exactly.

From one random ``SwitchState`` and one random subround-major ingress,
the port's ``window_pipeline`` must equal the reference's: every
subround output, the serve intervals and the end-of-window state (value
bytes included, so ``install_window_values`` is covered, with F = 2
multi-fragment lines too).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import kernels as jkn  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.hashing import hash128_u32_np  # noqa: E402
from repro.core.types import PacketBatch, init_switch_state  # noqa: E402
from torch_parity import assert_trees_equal  # noqa: E402

from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    from_numpy, switch_state_from_numpy, to_numpy)


def random_state(rng, c, s, f, pad):
    """A reference SwitchState (numpy leaves) with random, consistent tables."""
    sw = jax.tree.map(np.asarray, init_switch_state(c, s, pad, f))
    keys = rng.choice(4 * c, c, replace=False).astype(np.int32)
    occ = rng.random(c) < 0.85
    version = rng.integers(0, 4, c).astype(np.int32)
    qlen = rng.integers(0, s + 1, c).astype(np.int32)
    front = rng.integers(0, s, c).astype(np.int32)
    u32max = np.uint32(2**32 - 1)
    return sw._replace(
        lookup=sw.lookup._replace(hkeys=hash128_u32_np(keys), occupied=occ,
                                  kidx=np.where(occ, keys, -1)),
        state=sw.state._replace(valid=rng.random(c) < 0.8, version=version),
        reqtab=sw.reqtab._replace(
            client=rng.integers(-1, 8, c * s).astype(np.int32),
            seq=rng.integers(0, 1 << 20, c * s).astype(np.int32),
            port=rng.integers(0, 100, c * s).astype(np.int32),
            ts=rng.random(c * s).astype(np.float32),
            kidx=rng.integers(-1, 4 * c, c * s).astype(np.int32),
            qlen=qlen, front=front, rear=(front + qlen) % s),
        orbit=sw.orbit._replace(
            live=rng.random(c * f) < 0.7,
            kidx=np.repeat(keys, f),
            version=np.repeat(version, f) + (rng.random(c * f) < 0.1),
            vlen=rng.integers(0, pad + 1, c * f).astype(np.int32),
            val=rng.integers(0, 256, (c * f, pad)).astype(np.uint8),
            frags=rng.integers(1, f + 1, c).astype(np.int32)),
        counters=sw.counters._replace(
            popularity=rng.integers(0, 2**32, c, dtype=np.uint64
                                    ).astype(np.uint32),
            hits=u32max - np.uint32(3), overflow=np.uint32(5),
            cached_reqs=u32max),
    ), keys


def random_ingress(rng, keys, r, lanes, f, pad):
    """A reference PacketBatch [R, L] (numpy) mixing every op code."""
    shape = (r, lanes)
    pool = np.concatenate([keys, rng.integers(0, 8 * len(keys), 8)])
    kidx = rng.choice(pool, shape).astype(np.int32)
    op = rng.integers(0, 8, shape).astype(np.int32)
    frag_no = rng.integers(0, f + 1, shape).astype(np.int32)
    seq = np.where(op == 5, frag_no, rng.integers(0, 1 << 20, shape)
                   ).astype(np.int32)
    return PacketBatch(
        op=op, seq=seq, hkey=hash128_u32_np(kidx),
        flag=rng.integers(0, f + 1, shape).astype(np.int32), kidx=kidx,
        vlen=rng.integers(0, pad * f + 1, shape).astype(np.int32),
        client=rng.integers(0, 4, shape).astype(np.int32),
        port=rng.integers(0, f, shape).astype(np.int32),
        server=rng.integers(0, 4, shape).astype(np.int32),
        ts=(rng.random(shape) * 100).astype(np.float32),
        valid=rng.random(shape) < 0.9,
        val=rng.integers(0, 256, shape + (pad,)).astype(np.uint8),
    )


# (seed, C, S, F, J, R, L, recirc_gbps): plain, multi-fragment, and a
# recirculation budget scarce enough that entries starve.
CASES = ((1, 16, 8, 1, 8, 4, 24, 100.0),
         (2, 12, 4, 2, 4, 4, 32, 100.0),
         (3, 16, 8, 2, 8, 2, 40, 0.05),
         (4, 8, 4, 1, 6, 3, 20, 0.5))


@pytest.mark.parametrize("seed,c,s,f,j,r,lanes,gbps", CASES)
def test_window_pipeline_matches_jax(seed, c, s, f, j, r, lanes, gbps):
    pad = 32
    rng = np.random.default_rng(seed)
    sw_np, keys = random_state(rng, c, s, f, pad)
    sub_np = random_ingress(rng, keys, r, lanes, f, pad)
    kw = dict(recirc_gbps=gbps, window_us=100.0, subrounds=r, max_serves=j,
              key_size=16)

    jkn.set_kernel_backend("ref")
    try:
        sw_j, outs_j, iv_j = jpipe.window_pipeline(
            jax.tree.map(jax.numpy.asarray, sw_np),
            jax.tree.map(jax.numpy.asarray, sub_np), **kw)
    finally:
        jkn.set_kernel_backend(None)
    cpu = torch.device("cpu")
    sw_t, outs_t, iv_t = tpipe.window_pipeline(
        switch_state_from_numpy(sw_np, cpu), from_numpy(sub_np, cpu), **kw)

    label = f"window_pipeline case {seed}"
    assert_trees_equal(outs_t, outs_j, label + " outs")
    np.testing.assert_array_equal(to_numpy(iv_t), np.asarray(iv_j),
                                  err_msg=label + " intervals")
    assert_trees_equal(sw_t, sw_j, label + " state")
    # the case must exercise what it claims: installs happen
    assert int(np.asarray(outs_j.stats.n_install).sum()) > 0
