"""The port's optimizer, loss, data and checkpoint layout against the JAX
reference, and the training converters of ``repro_torch.interop``.

Bounds, and why:

* ``schedule`` and ``global_norm`` within ``ULPS`` float32 ulps, and
  ``adamw_update`` (fed the reference's gradients and state) within
  ``BOUND`` (float32 eps times the magnitude of each result's terms; bf16
  moments one bf16 ulp): the arithmetic is the reference's in its order,
  but float32 ``cos`` and ``pow`` are not correctly rounded on either
  side (the learning rate may sit an ulp off), XLA fuses the update, and
  ``global_norm`` sums per-layer leaves where the reference sums a
  stacked leaf, so the clip scale may move an ulp.
* ``loss_fn`` within rtol 1e-6 (float32 ``logsumexp`` sums differ).
* ``tokens_from_uniform`` exactly, on the uniforms that the reference's
  ``SyntheticStream.batch`` draws (``data.py:41-44``).
* the port's native draw: the even positions' Kolmogorov-Smirnov
  distance to the Zipf CDF below the 0.001-level critical value
  ``1.95 / sqrt(n)``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, reduced  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.data import DataConfig as JDataConfig  # noqa: E402
from repro.training.data import SyntheticStream as JStream  # noqa: E402
from repro.training.train_step import loss_fn as j_loss_fn  # noqa: E402

from repro_torch import configs as tcfg  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.data import (DataConfig, SyntheticStream,  # noqa: E402
                                       tokens_from_uniform, zipf_cdf)
from repro_torch.training.train_step import IGNORE_LABEL, loss_fn  # noqa: E402

ULPS = 2
EPS = {"float32": float(np.finfo(np.float32).eps),
       "bfloat16": float(jnp.finfo(jnp.bfloat16).eps)}
# adamw_update: errors in units of eps times the sum of the magnitudes of
# the terms that make each result (the update cancels); float32 measured
# at most 3.7 (params), 2.9 (mu), 4.7 (nu, the clip scale an ulp apart);
# bf16 moments one bf16 ulp (a float32 ulp below may flip the rounding)
BOUND = {"float32": 6.0, "bfloat16": 1.01}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ulps(a, b):
    """Float32 ulp distance, entry by entry."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


SCHEDULES = [dict(lr=3e-4, warmup_steps=100, total_steps=10_000),
             dict(lr=3e-3, warmup_steps=5, total_steps=20),
             dict(lr=1.0, warmup_steps=10, total_steps=100,
                  min_lr_frac=0.1),
             dict(lr=1e-3, warmup_steps=7, total_steps=301,
                  min_lr_frac=0.03)]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_schedule_matches_reference(kw):
    """Step 0, the end of warmup, mid-decay, the end and past it."""
    jc, tc = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    w, t = tc.warmup_steps, tc.total_steps
    for s in (0, 1, w // 2, w, w + 1, (w + t) // 2, t - 1, t, t + 5):
        want = np.float32(jopt.schedule(jnp.int32(s), jc))
        got = topt.schedule(torch.tensor(s, dtype=torch.int32), tc)
        assert got.dtype == torch.float32
        assert ulps(got.numpy(), want) <= ULPS, (s, float(got), want)


@functools.lru_cache(maxsize=None)
def _ref_params(name="deepseek-v2-lite-16b", dtype="float32"):
    """The port's config and a parameter tree of the reference's structure,
    shapes and dtypes (``jax.eval_shape`` of its init), filled from a seed
    with numpy (normal x 0.02)."""
    cfg = dataclasses.replace(reduced(ARCHS[name]), dtype=dtype)
    pcfg = dataclasses.replace(tcfg.reduced(tcfg.ARCHS[name]), dtype=dtype)
    shapes = jax.eval_shape(j_build(cfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: np.asarray(jnp.asarray(
        rng.standard_normal(a.shape) * 0.02, a.dtype)), shapes)
    return pcfg, params


def _like(tree, seed, scale=1e-2, positive=False):
    rng = np.random.default_rng(seed)

    def draw(a):
        x = rng.standard_normal(a.shape).astype(np.float32) * scale
        return np.abs(x) if positive else x
    return jax.tree.map(draw, tree)


def test_global_norm_matches_reference():
    _, params = _ref_params()
    grads = _like(params, 1)
    want = np.float32(jopt.global_norm(jax.tree.map(jnp.asarray, grads)))
    got = topt.global_norm(interop.lm_tree_from_reference(grads, "cpu"))
    assert ulps(got.numpy(), want) <= ULPS


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [1.0, 1e3])
def test_adamw_update_matches_reference(state_dtype, clip_norm):
    """One update from a state 6 steps in, on the reference's gradients
    and moments: clipping active (norm 1) and inactive (1e3)."""
    pcfg, params = _ref_params(dtype="float32")
    kw = dict(lr=1e-3, warmup_steps=5, total_steps=40, clip_norm=clip_norm,
              state_dtype=state_dtype)
    jc, tc = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    dt = jnp.bfloat16 if state_dtype == "bfloat16" else jnp.float32
    grads = _like(params, 2)
    st = jopt.AdamWState(
        step=np.int32(6),
        mu=jax.tree.map(lambda x: np.asarray(jnp.asarray(x, dt)),
                        _like(params, 3, 1e-3)),
        nu=jax.tree.map(lambda x: np.asarray(jnp.asarray(x, dt)),
                        _like(params, 4, 1e-6, positive=True)))
    jp, jst, jm = jax.jit(lambda p, g, s: jopt.adamw_update(p, g, s, jc))(
        *(jax.tree.map(jnp.asarray, x) for x in (params, grads, st)))

    model = interop.lm_params_from_reference(
        build_model(pcfg, device="cpu"), params)
    tp = {k: p.detach() for k, p in model.named_parameters()}
    new_p, new_st, m = topt.adamw_update(
        tp, interop.lm_tree_from_reference(grads, "cpu"),
        interop.adamw_state_from_reference(model, st), tc)
    assert int(new_st.step) == 7
    for k in ("lr", "grad_norm"):
        assert ulps(m[k].numpy(), np.float32(jm[k])) <= ULPS, k
    got_p = interop.lm_params_to_reference(new_p)
    got_st = interop.adamw_state_to_reference(new_st)
    b1, b2 = jc.b1, jc.b2
    leaves = lambda t: [np.asarray(x, np.float64) for x in jax.tree.leaves(t)]
    for p0, g, m0, n0, pw, pg, mw, mg, nw, ng in zip(
            *map(leaves, (params, grads, st.mu, st.nu, jp, got_p, jst.mu,
                          got_st.mu, jst.nu, got_st.nu)), strict=True):
        gs = np.abs(g) * min(1.0, clip_norm / float(jm["grad_norm"]))
        # each result against the sum of the magnitudes of the terms that
        # make it: the update may cancel (b1 * mu + (1 - b1) * g, and
        # p - lr * (mhat / (sqrt(vhat) + eps) + wd * p))
        mu_terms = b1 * np.abs(m0) + (1 - b1) * gs
        bc1, bc2 = 1 - b1 ** 7, 1 - b2 ** 7
        p_terms = np.abs(p0) + float(jm["lr"]) * (
            mu_terms / bc1 / (np.sqrt(nw / bc2) + jc.eps)
            + jc.weight_decay * np.abs(p0))
        for what, got, want, scale in (
                ("p", pg, pw, p_terms),
                ("mu", mg, mw, mu_terms),
                ("nu", ng, nw, b2 * n0 + (1 - b2) * gs * gs)):
            assert got.shape == want.shape
            kind = state_dtype if what != "p" else "float32"
            err = np.abs(got - want) / (EPS[kind] * np.maximum(scale, 1e-30))
            assert err.max() <= BOUND[kind], (what, float(err.max()))


def test_loss_fn_matches_reference():
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((3, 5, 17)) * 4).astype(np.float32)
    labels = rng.integers(0, 17, (3, 5)).astype(np.int32)
    labels[1] = IGNORE_LABEL          # a whole ignored row
    labels[2, 1:3] = IGNORE_LABEL
    want = float(j_loss_fn(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(loss_fn(torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # every label ignored: the mean over max(count, 1) is 0
    none = np.full((3, 5), IGNORE_LABEL, np.int32)
    assert float(loss_fn(torch.from_numpy(logits),
                         torch.from_numpy(none))) == 0.0
    assert float(j_loss_fn(jnp.asarray(logits), jnp.asarray(none))) == 0.0


@pytest.mark.parametrize("vocab", [100, 151_936])
def test_tokens_from_uniform_is_exact(vocab):
    """The reference's uniforms (``jax.random`` exactly as ``data.py:41-44``
    draws them) through the port's remainder give the reference's batch."""
    kw = dict(vocab_size=vocab, seq_len=24, global_batch=6, seed=11)
    jds, dc = JStream(JDataConfig(**kw)), DataConfig(**kw)
    np.testing.assert_array_equal(zipf_cdf(dc), np.asarray(jds._cdf))
    for step, shards, shard in ((0, 1, 0), (5, 1, 0), (5, 2, 1), (123, 3, 2)):
        rng = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(dc.seed), step), shard)
        r1, _ = jax.random.split(rng)
        u = jax.random.uniform(r1, (dc.global_batch // shards, dc.seq_len),
                               jnp.float32)
        want = jds.batch(step, num_shards=shards, shard=shard)
        got = tokens_from_uniform(torch.from_numpy(np.array(u)), dc)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


def test_native_draw_marginals_follow_zipf():
    """Even positions are Zipf ranks (KS against the CDF), odd positions
    the Markov successor of the token before them."""
    dc = DataConfig(vocab_size=1000, seq_len=256, global_batch=64, seed=2)
    ds = SyntheticStream(dc, device="cpu")
    toks = torch.cat([ds.batch(s)["tokens"] for s in range(4)]).numpy()
    even = toks[:, 0::2].ravel()
    assert toks.min() >= 0 and toks.max() < dc.vocab_size
    n = even.size
    emp = np.cumsum(np.bincount(even, minlength=dc.vocab_size)) / n
    d = np.abs(emp - zipf_cdf(dc)).max()
    assert d < 1.95 / np.sqrt(n), (d, 1.95 / np.sqrt(n))
    np.testing.assert_array_equal(
        toks[:, 1::2], (toks[:, 0::2] * dc.markov_jump + 1) % dc.vocab_size)


def test_checkpoints_cross_between_port_and_reference(tmp_path):
    """``latest`` finds the reference's committed steps and ignores torn
    ones; each side restores the other's checkpoint of the same tree."""
    d = str(tmp_path)
    tree = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "nested": {"b": np.asarray(jnp.full((2,), 1.5, jnp.bfloat16)),
                       "i": np.arange(3, dtype=np.int32)}}
    jtree = jax.tree.map(jnp.asarray, tree)
    for s in (3, 7):
        jckpt.save(d, s, jtree)
    (tmp_path / "step_00000009").mkdir()            # torn: no COMMITTED
    (tmp_path / "step_00000011.tmp").mkdir()        # torn: never renamed
    assert ckpt.latest(d) == jckpt.latest(d) == 7
    like = {"w": torch.zeros(3, 4), "nested": {
        "b": torch.zeros(2, dtype=torch.bfloat16),
        "i": torch.zeros(3, dtype=torch.int32)}}
    back = ckpt.restore(d, 7, like)
    assert back["nested"]["b"].dtype == torch.bfloat16
    assert float(back["nested"]["b"][0]) == 1.5
    np.testing.assert_array_equal(back["w"].numpy(), tree["w"])
    np.testing.assert_array_equal(back["nested"]["i"].numpy(),
                                  tree["nested"]["i"])

    ckpt.save(d, 12, back)
    assert jckpt.latest(d) == 12
    jback = jckpt.restore(d, 12, jax.tree.map(jnp.zeros_like, jtree))
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_interop_roundtrip(name):
    """Reference tree -> port -> reference tree, equal leaf for leaf, for
    the parameters (bf16 where the reference's are) and an AdamW state
    with bf16 moments."""
    pcfg, params = _ref_params(name, dtype="bfloat16")
    model = interop.lm_params_from_reference(
        build_model(pcfg, device="cpu"), params)
    back = interop.lm_params_to_reference(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    st = jopt.AdamWState(
        step=np.int32(4),
        mu=jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)),
                        _like(params, 6)),
        nu=_like(params, 7, positive=True))
    pst = interop.adamw_state_from_reference(model, st)
    assert pst.step.dtype == torch.int32 and int(pst.step) == 4
    assert all(v.dtype == torch.bfloat16 for v in pst.mu.values())
    got = interop.adamw_state_to_reference(pst)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(st)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
