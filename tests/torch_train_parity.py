"""Shared checks of the port's training path against the JAX reference
(``tests/test_torch_train_{dense,multimodal,moe,xlstm,zamba2}.py``).

Each arch runs at ``reduced()`` size on the reference's own float32
parameters (``interop.lm_params_from_reference``).  Two inputs:

* the gradient check's batch, made from a seed with numpy (B = 2, S = 12
  random tokens and labels, a fifth of the labels ``IGNORE_LABEL``);
* ``tests/test_archs_smoke.py``'s training batch (B = 2, S = 32), its
  bfloat16 leaves widened to float32 (exact) for the float32 runs.

The reference's jitted results are computed once per process (``_REF``),
each only for the tests that need it.

Bounds, and why:

* loss, aux and every gradient leaf within ``1e-4 * max|leaf| + 1e-6`` of
  ``jax.value_and_grad`` of the reference's ``_microbatch_loss``: XLA:CPU
  and torch order the matmul and reduction sums differently, so float32
  does not hold bits (the forward holds 1e-4, ``torch_lm_parity.py``).
* one ``train_step`` (2 microbatches, ``AdamWConfig(lr=1e-3)``): its
  metrics within rtol 1e-4; ``mu``, ``nu`` and the new parameters within
  bounds derived entry by entry from the gradient bound.  The first
  AdamW step moves a parameter by ``lr * (g / (|g| + eps) + wd * p)``,
  nearly ``sign(g) * lr``, so an entry whose gradient lies within the
  gradient bound of zero may move by up to ``2 * lr`` more or less than
  the reference's; an entry with ``|g|`` well above the bound is held to
  ``lr * bound / |g|``.  The gradient ``g`` (clipped) is read off the
  reference's ``mu = (1 - b1) * g``.  Only entries with ``|g|`` within
  twice the gradient bound get the ``2 * lr`` end; on the smoke batch
  (one token repeated) they are the attention's ``wq`` / ``wk``, whose
  gradient is zero but for roundoff, and rarely used embedding rows.
  Measured (qwen2-0.5b, mixtral-8x7b): every parameter within 0.0085 lr
  of the reference, ``mu`` within 0.013 of its bound.
* bfloat16: the port's step on the bf16 model (the float32 parameters
  rounded, as the reference's bf16 init rounds its float32 draws) has a
  finite loss within 2e-2 (the reference's bf16 bound) of the
  reference's float32 loss on the same batch, a positive grad norm, and
  moved parameters, as ``test_archs_smoke.py::test_train_step`` asks.
* remat on and off: loss and every gradient bit-equal on the CPU (the
  checkpointed forward recomputes the same ops in the same order).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.models.model import build_model as j_build
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import adamw_init as j_adamw_init
from repro.training.train_step import TrainConfig as JTrainConfig
from repro.training.train_step import _microbatch_loss as j_mb_loss
from repro.training.train_step import make_train_step as j_make_train_step

from repro_torch import configs as tcfg
from repro_torch import interop
from repro_torch.models import build_model
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_step import (IGNORE_LABEL, TrainConfig,
                                             _microbatch_loss,
                                             make_train_step)

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
METRIC_RTOL = 1e-4
BF16_TOL = 2e-2
LR, MICROBATCHES = 1e-3, 2
B, S = 2, 12           # the gradient check's batch
SB, SS = 2, 32         # test_archs_smoke.py's batch
_REF: dict = {}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg_pair(name, dtype="float32"):
    ref = dataclasses.replace(reduced(ARCHS[name]), dtype=dtype)
    port = dataclasses.replace(tcfg.reduced(tcfg.ARCHS[name]), dtype=dtype)
    return ref, port


def grad_batch(cfg, seed=0):
    """Random tokens (codes for audio) and labels, numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    if cfg.num_codebooks:
        batch = {"frame_embeds": rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)}
        lab_shape = (B, S, cfg.num_codebooks)
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                        dtype=np.int32)}
        s_tot = S
        if cfg.frontend == "vision_stub":
            tv = cfg.vision_tokens
            s_tot = S + tv
            batch["vision_embeds"] = rng.standard_normal(
                (B, tv, cfg.d_model)).astype(np.float32)
            batch["mrope_pos"] = np.stack([
                np.broadcast_to(np.arange(s_tot, dtype=np.int32) // (k + 1),
                                (B, s_tot)) for k in range(3)])
        lab_shape = (B, s_tot)
    labels = rng.integers(0, cfg.vocab_size, lab_shape, dtype=np.int32)
    labels[rng.random(lab_shape) < 0.2] = IGNORE_LABEL
    batch["labels"] = labels
    return batch


def smoke_batch(cfg, dtype=np.float32):
    """``tests/test_archs_smoke.py::make_batch(cfg, train=True)`` as
    numpy; its bf16 leaves (0.1, i.e. 0.10009765625 in bf16) in
    ``dtype``."""
    fill = float(jnp.asarray(0.1, jnp.bfloat16))
    if cfg.num_codebooks:
        return {"frame_embeds": np.full((SB, SS, cfg.d_model), fill, dtype),
                "labels": np.ones((SB, SS, cfg.num_codebooks), np.int32)}
    batch = {}
    if cfg.frontend == "vision_stub":
        tv = cfg.vision_tokens
        batch["tokens"] = np.ones((SB, SS - tv), np.int32)
        batch["vision_embeds"] = np.full((SB, tv, cfg.d_model), fill, dtype)
        batch["mrope_pos"] = np.ascontiguousarray(np.broadcast_to(
            np.arange(SS, dtype=np.int32)[None, None], (3, SB, SS)))
    else:
        batch["tokens"] = np.ones((SB, SS), np.int32) * 3
    batch["labels"] = np.ones((SB, SS), np.int32)
    return batch


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch, dtype=None):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[k] = t
    return out


def _cached(kind, name, make):
    if (kind, name) not in _REF:
        _REF[kind, name] = make()
    return _REF[kind, name]


def _npy(tree):
    return jax.tree.map(np.asarray, tree)


def _jtc():
    return JTrainConfig(microbatches=MICROBATCHES, opt=JAdamWConfig(lr=LR))


def ref_params(name):
    """The reference's float32 parameters (its init, key 0)."""
    def make():
        cfg, _ = cfg_pair(name)
        return j_build(cfg).init(jax.random.PRNGKey(0))
    return _cached("params", name, make)


def reference_grads(name):
    """The reference's loss, aux and grads on the gradient batch (numpy),
    from ``jax.value_and_grad`` of its ``_microbatch_loss``."""
    def make():
        cfg, _ = cfg_pair(name)
        tc = _jtc()
        vg = jax.jit(jax.value_and_grad(
            lambda p, b: j_mb_loss(p, b, cfg, tc, None), has_aux=True))
        (tot, (loss, aux)), grads = vg(ref_params(name),
                                       to_jax(grad_batch(cfg)))
        return dict(params=_npy(ref_params(name)), tot=float(tot),
                    loss=float(loss), aux=float(aux), grads=_npy(grads))
    return _cached("grads", name, make)


def reference_step(name):
    """One reference train step on the smoke batch (numpy)."""
    def make():
        cfg, _ = cfg_pair(name)
        tc = _jtc()
        params = ref_params(name)
        p2, o2, mt = jax.jit(j_make_train_step(cfg, tc))(
            params, j_adamw_init(params, tc.opt), to_jax(smoke_batch(cfg)))
        return dict(params=_npy(params), new_params=_npy(p2),
                    mu=_npy(o2.mu), nu=_npy(o2.nu), step=int(o2.step),
                    metrics={k: float(v) for k, v in mt.items()})
    return _cached("step", name, make)


def port_model(name, params, dtype="float32"):
    _, cfg = cfg_pair(name, dtype)
    return interop.lm_params_from_reference(build_model(cfg, device="cpu"),
                                            params)


def port_grads(model, cfg, batch):
    """``(tot, loss, aux, grads)`` of the port's microbatch loss."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    tot, (loss, aux) = _microbatch_loss(model, batch, cfg, TrainConfig())
    grads = torch.autograd.grad(tot, list(params.values()),
                                allow_unused=True)
    return (tot.detach(), loss.detach(), aux.detach(),
            {k: (torch.zeros_like(p) if g is None else g)
             for (k, p), g in zip(params.items(), grads)})


def _pairs(got, want, path=""):
    """Leaf pairs of two nested dicts with the same keys."""
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for k in sorted(want):
        if isinstance(want[k], dict):
            yield from _pairs(got[k], want[k], f"{path}/{k}")
        else:
            yield f"{path}/{k}", np.asarray(got[k], np.float64), \
                np.asarray(want[k], np.float64)


def grad_bound(w):
    return GRAD_RTOL * np.abs(w).max() + GRAD_ATOL


def check_grads(name):
    want = reference_grads(name)
    cfg, pcfg = cfg_pair(name)
    model = port_model(name, want["params"])
    tot, loss, aux, grads = port_grads(model, pcfg,
                                       to_torch(grad_batch(cfg)))
    for k in ("tot", "loss", "aux"):
        got = float({"tot": tot, "loss": loss, "aux": aux}[k])
        np.testing.assert_allclose(got, want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    got = interop.lm_params_to_reference(grads)
    n = 0
    for path, g, w in _pairs(got, want["grads"]):
        assert g.shape == w.shape, path
        err = np.abs(g - w).max()
        assert err <= grad_bound(w), (path, err, grad_bound(w))
        n += 1
    return n


def _step_bounds(want, lr):
    """Per-leaf bounds on ``mu``, ``nu`` and the new params, derived from
    the gradient bound (module docstring)."""
    c = JAdamWConfig()
    out = {}
    for path, mu, _ in _pairs(want["mu"], want["mu"]):
        g = mu / (1 - c.b1)                       # the clipped gradient
        tol = grad_bound(g)
        ag = np.abs(g)
        far = np.maximum(ag - tol, 0.0)
        p_tol = lr * np.minimum(2.0, tol / (far + c.eps)) * 1.01
        out[path] = dict(
            mu=(1 - c.b1) * tol * 1.01,
            nu=(1 - c.b2) * (2 * ag * tol + tol * tol) * 1.01 + 1e-30,
            p=p_tol)
    return out


def check_train_step(name):
    """One port ``train_step`` (2 microbatches) on the smoke batch against
    the reference's: metrics, ``mu``, ``nu`` and the new parameters."""
    want = reference_step(name)
    cfg, pcfg = cfg_pair(name)
    model = port_model(name, want["params"])
    tc = TrainConfig(microbatches=MICROBATCHES, opt=AdamWConfig(lr=LR))
    params = dict(model.named_parameters())
    opt = adamw_init(params, tc.opt)
    opt, mt = make_train_step(pcfg, tc)(model, opt,
                                        to_torch(smoke_batch(cfg)))
    assert_step_close(want, opt, dict(model.named_parameters()), mt)
    return mt


def assert_step_close(want, opt, params, mt):
    """A port step's AdamW state, parameters (dicts of plain tensors) and
    metrics against the reference step ``want``, within the bounds of the
    module docstring."""
    assert int(opt.step) == want["step"] == 1
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(float(mt[k]), v, rtol=METRIC_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    lr = want["metrics"]["lr"]
    bounds = _step_bounds(want, lr)
    st = interop.adamw_state_to_reference(opt)
    new_p = interop.lm_params_to_reference(params)
    for what, got, ref in (("mu", st.mu, want["mu"]),
                           ("nu", st.nu, want["nu"]),
                           ("p", new_p, want["new_params"])):
        for path, g, w in _pairs(got, ref):
            tol = bounds[path][what]
            if what == "p":  # the float32 rounding of the parameter itself
                tol = tol + 4 * np.finfo(np.float32).eps * np.abs(w)
            bad = np.abs(g - w) > tol
            assert not bad.any(), (what, path, np.abs(g - w)[bad].max())


def check_bf16_step(name):
    """The port's bf16 step: finite loss within 2e-2 of the reference's
    float32 loss on the same batch, grad norm > 0, parameters moved."""
    want = reference_step(name)
    cfg, pcfg = cfg_pair(name, "bfloat16")
    model = port_model(name, want["params"], "bfloat16")
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    tc = TrainConfig(microbatches=MICROBATCHES, opt=AdamWConfig(lr=LR))
    opt = adamw_init(dict(model.named_parameters()), tc.opt)
    _, mt = make_train_step(pcfg, tc)(
        model, opt, to_torch(smoke_batch(cfg), torch.bfloat16))
    loss = float(mt["loss"])
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, want["metrics"]["loss"], rtol=BF16_TOL,
                               atol=BF16_TOL)
    assert float(mt["grad_norm"]) > 0
    delta = max(float((p.detach().float() - before[k].float()).abs().max())
                for k, p in model.named_parameters())
    assert delta > 0


def check_remat(name):
    """Loss and gradients with remat on and off, bit-equal on the CPU."""
    want = reference_grads(name)
    cfg, pcfg = cfg_pair(name)
    assert pcfg.remat
    model = port_model(name, want["params"])
    batch = to_torch(grad_batch(cfg))
    on = port_grads(model, pcfg, batch)
    off = port_grads(model, dataclasses.replace(pcfg, remat=False), batch)
    for a, b in zip(on[:3], off[:3]):
        assert torch.equal(a, b)
    for k in on[3]:
        assert torch.equal(on[3][k], off[3][k]), k
