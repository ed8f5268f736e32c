"""The port's language-model layers (``repro_torch.models``) against the
JAX reference's, one unit function at a time, on seeded numpy inputs and
on the reference's own parameters.

Tolerance: float32, rtol = atol = 1e-4 (XLA:CPU and torch order matmul
and reduction sums differently, so bit equality does not hold here);
the recurrent scans with exponential gating hold the same bound.
"""
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, reduced  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import embedding as je  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import moe as jm  # noqa: E402
from repro.models import ssm as js  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402

from repro_torch.configs import ARCHS as T_ARCHS  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.interop import (from_numpy, lm_params_from_reference,  # noqa: E402
                                 lm_state_from_reference,
                                 lm_state_to_reference, to_numpy)
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import embedding as te  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402
from repro_torch.models import ssm as ts  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
F32 = jnp.float32


def cfgs(name, **moe):
    """The reduced float32 config of ``name`` in both packages."""
    ref = dataclasses.replace(reduced(ARCHS[name]), dtype="float32")
    port = dataclasses.replace(t_reduced(T_ARCHS[name]), dtype="float32")
    if moe:
        ref = dataclasses.replace(ref, moe=dataclasses.replace(ref.moe, **moe))
        port = dataclasses.replace(port,
                                   moe=dataclasses.replace(port.moe, **moe))
    return ref, port


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def load(module, tree):
    """The reference's parameter dict (numpy leaves) into a port module
    whose attribute paths carry the same names."""
    return lm_params_from_reference(module, tree)


def init_pair(ref_init, port_cls, cfg_ref, cfg_port, seed=0):
    params = np_tree(ref_init(jax.random.PRNGKey(seed), cfg_ref, F32))
    gen = torch.Generator().manual_seed(seed)
    port = port_cls(tl.Init(gen, "cpu"), cfg_port, torch.float32)
    return params, load(port, params)


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, **tol):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                               **(tol or TOL))


def close_tree(got, want):
    for g, w in zip(jax.tree.leaves(to_numpy(got)), jax.tree.leaves(want),
                    strict=True):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **TOL)


# ---------------------------------------------------------------------------
# norms, MLP, RoPE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_and_mlp(dtype):
    jdt = jnp.dtype(dtype)
    x = rand(0, 3, 5, 64)
    g = 1 + rand(1, 64, scale=0.1)
    gh = 1 + rand(2, 4, 16, scale=0.1)
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    jx_, jg = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    tx_ = from_numpy(np.asarray(jx_), "cpu")
    close(tl.rmsnorm(tx_, SimpleNamespace(g=from_numpy(np.asarray(jg), "cpu")),
                     1e-6),
          jl.rmsnorm(jx_, {"g": jg}, 1e-6).astype(F32), **tol)
    xh = x.reshape(3, 5, 4, 16)
    close(tl.groupnorm_heads(t(xh), SimpleNamespace(g=t(gh))),
          jl.groupnorm_heads(jnp.asarray(xh), {"g": jnp.asarray(gh)}))
    p = np_tree(jl.init_mlp(jax.random.PRNGKey(3), 64, 96, jdt))
    port = load(tl.MLP(tl.Init(torch.Generator(), "cpu"), 64, 96,
                       tl.dtype_of(dtype)), p)
    close(tl.mlp(tx_, port), jl.mlp(jx_, p).astype(F32), **tol)


@pytest.mark.parametrize("dh,theta", [(32, 1e4), (64, 1e6), (128, 5e5),
                                      (112, 1e4)])
def test_rope(dh, theta):
    # the reference's order, within an ulp (neither float32 pow is
    # correctly rounded; layers.rope_freqs)
    np.testing.assert_allclose(tl.rope_freqs(dh, theta).numpy(),
                               np.asarray(jl.rope_freqs(dh, theta)),
                               rtol=2**-23, atol=0)
    x = rand(dh, 2, 7, 3, dh)
    pos = np.random.default_rng(dh).integers(0, 4096, (2, 7)).astype(np.int32)
    close(tl.apply_rope(t(x), t(pos), theta),
          jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("dh", [32, 128])
def test_mrope(dh):
    x = rand(5, 2, 6, 3, dh)
    pos3 = np.random.default_rng(6).integers(0, 64, (3, 2, 6)).astype(
        np.int32)
    close(tl.apply_mrope(t(x), t(pos3), (16, 24, 24), 1e6),
          jl.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), (16, 24, 24),
                         1e6))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,window,hkv,t_len,kv_chunk,q_offset", [
    (True, None, 4, 32, 32, 0),     # one chunk, MHA
    (True, None, 2, 40, 16, 0),     # GQA groups, t % kv_chunk != 0
    (True, 8, 1, 33, 16, 0),        # sliding window, MQA
    (False, None, 2, 24, 16, 0),    # not causal
    (True, 12, 2, 40, 16, 8),       # q_offset: the last queries of t
])
def test_chunked_attention(causal, window, hkv, t_len, kv_chunk, q_offset):
    s = t_len - q_offset
    q, k, v = (rand(10, 2, s, 4, 16), rand(11, 2, t_len, hkv, 16),
               rand(12, 2, t_len, hkv, 8))
    f = jax.jit(functools.partial(ja.chunked_attention, causal=causal,
                                  window=window, q_offset=q_offset,
                                  kv_chunk=kv_chunk))
    close(ta.chunked_attention(t(q), t(k), t(v), causal=causal,
                               window=window, q_offset=q_offset,
                               kv_chunk=kv_chunk),
          f(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


def test_decode_attention():
    q, k, v = rand(20, 3, 1, 8, 16), rand(21, 3, 10, 2, 16), \
        rand(22, 3, 10, 2, 16)
    n = np.array([1, 7, 10], np.int32)
    close(ta.decode_attention(t(q), t(k), t(v), t(n)),
          jax.jit(ja.decode_attention)(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(n)))


def test_gqa_decode_ring_buffer_wraps():
    """A 3-slot cache over 5 steps: writes at ``len % t`` wrap, and
    ``min(len + 1, t)`` slots are attended."""
    cref, cport = cfgs("qwen2-0.5b")
    params, port = init_pair(ja.init_gqa, ta.GQA, cref, cport)
    b, t_len, hkv, hd = 2, 3, cref.num_kv_heads, cref.resolved_head_dim
    ck = cv = jnp.zeros((b, t_len, hkv, hd), F32)
    pk, pv = torch.zeros((b, t_len, hkv, hd)), torch.zeros((b, t_len, hkv, hd))
    n = jnp.array([0, 2], jnp.int32)
    pn = torch.tensor([0, 2], dtype=torch.int32)
    step = jax.jit(functools.partial(ja.gqa_decode, cfg=cref))
    for i in range(5):
        x = rand(30 + i, b, 1, cref.d_model)
        pos = n[:, None]
        out, (ck, cv, n) = step(jnp.asarray(x), params, cache_k=ck,
                                cache_v=cv, cache_len=n, pos=pos)
        pout, (pk, pv, pn) = ta.gqa_decode(t(x), port, cport, pk, pv, pn,
                                           pn[:, None])
        close(pout, out)
        close(pk, ck)
        close(pv, cv)
        np.testing.assert_array_equal(pn.numpy(), np.asarray(n))


def test_mla_forward_and_decode():
    cref, cport = cfgs("deepseek-v2-lite-16b")
    params, port = init_pair(ja.init_mla, ta.MLA, cref, cport)
    b, s = 2, 9
    x = rand(40, b, s, cref.d_model)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    out, (c, kr) = jax.jit(functools.partial(ja.mla_forward, cfg=cref))(
        jnp.asarray(x), params, pos=jnp.asarray(pos))
    pout, (pc, pkr) = ta.mla_forward(t(x), port, cport, t(pos))
    close(pout, out)
    close(pc, c)
    close(pkr, kr)
    m = cref.mla
    cc, ckr = jnp.zeros((b, 4, m.kv_lora_rank), F32), \
        jnp.zeros((b, 4, m.qk_rope_head_dim), F32)
    pcc, pckr = torch.zeros(cc.shape), torch.zeros(ckr.shape)
    n, pn = jnp.zeros((b,), jnp.int32), torch.zeros((b,), dtype=torch.int32)
    step = jax.jit(functools.partial(ja.mla_decode, cfg=cref))
    for i in range(6):      # the 4-slot latent cache wraps
        xi = x[:, i: i + 1]
        out, (cc, ckr, n) = step(jnp.asarray(xi), params, cache_c=cc,
                                 cache_kr=ckr, cache_len=n, pos=n[:, None])
        pout, (pcc, pckr, pn) = ta.mla_decode(t(xi), port, cport, pcc, pckr,
                                              pn, pn[:, None])
        close(pout, out)
        close(pcc, cc)
        close(pckr, ckr)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,capacity,zero_router", [
    ("mixtral-8x7b", 1.25, False),
    ("mixtral-8x7b", 0.5, False),          # drops
    ("deepseek-v2-lite-16b", 1.0, False),  # shared experts, top-2 of 4
    ("deepseek-v2-lite-16b", 1.0, True),   # every router score tied
])
def test_moe_layer(name, capacity, zero_router):
    cref, cport = cfgs(name, capacity_factor=capacity)
    params, port = init_pair(jm.init_moe, tm.MoE, cref, cport)
    if zero_router:
        params["router"]["w"] = np.zeros_like(params["router"]["w"])
        port.router.w.zero_()
    x = rand(50, 3, 11, cref.d_model)
    out, stats = jax.jit(functools.partial(jm.moe_layer, cfg=cref))(
        jnp.asarray(x), params)
    pout, pstats = tm.moe_layer(t(x), port, cport)
    close(pout, out)
    close_tree(pstats, np_tree(stats))
    if capacity < 1:
        assert float(pstats.dropped) > 0


def test_moe_topk_ties_go_to_the_lower_expert():
    """Six experts, top-3, scores tied in pairs: the stable descending
    sort picks what ``jax.lax.top_k`` picks."""
    probs = np.array([[0.1, 0.2, 0.2, 0.1, 0.2, 0.2]], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(probs), 3)
    got = torch.sort(t(probs), dim=-1, descending=True, stable=True)[1][:, :3]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Mamba2, mLSTM, sLSTM
# ---------------------------------------------------------------------------
def _states_pair(state, port_cls):
    ref = jax.tree.map(jnp.asarray, state)
    return ref, port_cls(*(t(np.array(a)) for a in state))


def test_mamba2_forward_and_decode():
    cref, cport = cfgs("zamba2-7b")
    params, port = init_pair(js.init_mamba2, ts.Mamba2, cref, cport)
    params["dt_bias"] = rand(60, *params["dt_bias"].shape, scale=0.5)
    port.dt_bias.copy_(t(params["dt_bias"]))
    b, s = 2, 45            # chunk 32: padded, two chunks
    x = rand(61, b, s, cref.d_model, scale=2.0)
    fwd = jax.jit(functools.partial(js.mamba2_forward, cfg=cref))
    out, st = fwd(jnp.asarray(x), params)
    pout, pst = ts.mamba2_forward(t(x), port, cport)
    close(pout, out)
    close_tree(pst, np_tree(st))
    # a second stretch from the carried state, then decode from it
    x2 = rand(62, b, 7, cref.d_model)
    out, st = fwd(jnp.asarray(x2), params, state=st)
    pout, pst = ts.mamba2_forward(t(x2), port, cport, pst)
    close(pout, out)
    close_tree(pst, np_tree(st))
    dec = jax.jit(functools.partial(js.mamba2_decode, cfg=cref))
    for i in range(3):
        xi = rand(63 + i, b, 1, cref.d_model)
        out, st = dec(jnp.asarray(xi), params, state=st)
        pout, pst = ts.mamba2_decode(t(xi), port, cport, pst)
        close(pout, out)
        close_tree(pst, np_tree(st))


def test_mlstm_forward_and_decode():
    cref, cport = cfgs("xlstm-1.3b")
    params, port = init_pair(jx.init_mlstm_block, tx.MLSTMBlock, cref, cport)
    b, s = 2, 40            # chunk 32: padded gates on the second chunk
    x = rand(70, b, s, cref.d_model, scale=4.0)
    fwd = jax.jit(functools.partial(jx.mlstm_forward, cfg=cref))
    out, st = fwd(jnp.asarray(x), params)
    pout, pst = tx.mlstm_forward(t(x), port, cport)
    close(pout, out)
    close_tree(pst, np_tree(st))
    dec = jax.jit(functools.partial(jx.mlstm_decode, cfg=cref))
    for i in range(3):
        xi = rand(71 + i, b, 1, cref.d_model, scale=4.0)
        out, st = dec(jnp.asarray(xi), params, state=st)
        pout, pst = tx.mlstm_decode(t(xi), port, cport, pst)
        close(pout, out)
        close_tree(pst, np_tree(st))


@pytest.mark.parametrize("s,time_chunk", [(12, 64), (40, 16)])
def test_slstm_forward_and_decode(s, time_chunk):
    """(40, 16): the sequence pads to 48 steps, and the final state is the
    one after the padded steps, in both packages."""
    cref, cport = cfgs("xlstm-1.3b")
    params, port = init_pair(jx.init_slstm_block, tx.SLSTMBlock, cref, cport)
    params["r"] = rand(80, *params["r"].shape, scale=0.3)
    port.r.copy_(t(params["r"]))
    x = rand(81, 2, s, cref.d_model, scale=2.0)
    fwd = jax.jit(functools.partial(jx.slstm_forward, cfg=cref,
                                    time_chunk=time_chunk))
    out, st = fwd(jnp.asarray(x), params)
    pout, pst = tx.slstm_forward(t(x), port, cport, time_chunk=time_chunk)
    close(pout, out)
    close_tree(pst, np_tree(st))
    dec = jax.jit(functools.partial(jx.slstm_decode, cfg=cref))
    xi = rand(82, 2, 1, cref.d_model)
    out, st = dec(jnp.asarray(xi), params, state=st)
    pout, pst = tx.slstm_decode(t(xi), port, cport, pst)
    close(pout, out)
    close_tree(pst, np_tree(st))


# ---------------------------------------------------------------------------
# embedding and the hot-row cache
# ---------------------------------------------------------------------------
def test_embed_hot_and_refresh():
    vocab, d = 97, 16
    p = np_tree(je.init_embedding(jax.random.PRNGKey(0), vocab, d, F32))
    port = load(te.Embedding(tl.Init(torch.Generator(), "cpu"), vocab, d,
                             torch.float32), p)
    rng = np.random.default_rng(90)
    counts = rng.integers(0, 5, vocab).astype(np.int32)   # many ties
    hot = je.refresh_hot_cache(p, jnp.asarray(counts), 12)
    phot = te.refresh_hot_cache(port, t(counts), 12)
    close_tree(phot, np_tree(hot))
    tokens = rng.integers(0, vocab, (3, 20)).astype(np.int64)
    want = je.embed_hot(jnp.asarray(tokens), p, hot)
    np.testing.assert_array_equal(
        te.embed_hot(t(tokens), port, phot).numpy(), np.asarray(want))
    np.testing.assert_array_equal(te.embed(t(tokens), port).numpy(),
                                  np.asarray(je.embed(jnp.asarray(tokens), p)))
    x = rand(91, 2, 3, d)
    close(te.logits(t(x), port), je.logits(jnp.asarray(x), p))
    close(te.logits(t(x), port, tie=True),
          je.logits(jnp.asarray(x), p, tie=True))


def test_decode_state_initial_values_cross():
    """``lm_state_from_reference`` carries the reference's fresh state
    (the ``-1e30`` / ``1e-6`` stabilisers) into the port's own."""
    from repro.models.model import init_decode_state as j_init
    from repro_torch.models.model import init_decode_state as t_init
    for name in ("xlstm-1.3b", "zamba2-7b", "deepseek-v2-lite-16b"):
        cref, cport = cfgs(name)
        want = lm_state_from_reference(np_tree(j_init(cref, 2, 8)), "cpu")
        got = t_init(cport, 2, 8, device="cpu")
        assert set(got) == set(want)
        for g, w in zip(jax.tree.leaves(lm_state_to_reference(got)),
                        jax.tree.leaves(lm_state_to_reference(want)),
                        strict=True):
            np.testing.assert_array_equal(g, w)
