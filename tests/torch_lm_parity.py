"""Shared checks of the port's language models against the JAX reference
(``tests/test_torch_lm_{models,recurrent}.py``).

Each arch runs at ``reduced()`` size on the reference's own parameters,
carried by ``interop.lm_params_from_reference``; the inputs are made from
a seed with numpy.  The reference's jitted outputs are computed once per
process and kept in ``_REF``.

Tolerances: float32 logits, ``aux`` and decode states within rtol = atol
= 1e-4 (XLA:CPU and torch order matmul and reduction sums differently,
so bit equality does not hold); bfloat16 forwards within 2e-2, the
reference's own bf16 bound.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS, LONG_CONTEXT_OK, SHAPES, reduced
from repro.models.model import build_model as j_build

from repro_torch import configs as tcfg
from repro_torch import interop
from repro_torch.models import build_model

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
B, S, STEPS = 2, 12, 4
_REF: dict = {}


def cfg_pair(name, dtype="float32"):
    ref = dataclasses.replace(reduced(ARCHS[name]), dtype=dtype)
    port = dataclasses.replace(tcfg.reduced(tcfg.ARCHS[name]), dtype=dtype)
    return ref, port


def inputs(cfg, seed=0):
    """(forward batch, decode batches) as numpy, made from ``seed``."""
    rng = np.random.default_rng(seed)
    dt = jnp.dtype(cfg.dtype)
    if cfg.num_codebooks:
        fe = np.asarray(jnp.asarray(
            rng.standard_normal((B, S, cfg.d_model)), dt))
        codes = rng.integers(0, cfg.vocab_size, (B, STEPS, cfg.num_codebooks))
        return {"frame_embeds": fe}, [{"codes": codes[:, i: i + 1]}
                                      for i in range(STEPS)]
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    batch = {"tokens": toks}
    steps = [{"tokens": toks[:, i: i + 1]} for i in range(STEPS)]
    if cfg.frontend == "vision_stub":
        tv = cfg.vision_tokens
        batch["vision_embeds"] = np.asarray(jnp.asarray(
            rng.standard_normal((B, tv, cfg.d_model)), dt))
        batch["mrope_pos"] = np.stack([
            np.broadcast_to(np.arange(S + tv, dtype=np.int32) // (k + 1),
                            (B, S + tv)) for k in range(3)])
        for i, st in enumerate(steps):
            st["mrope_pos"] = np.full((3, B, 1), tv + i, np.int32)
    return batch, steps


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: interop.from_numpy(v, "cpu") for k, v in batch.items()}


def reference(name, dtype="float32", cache_len=None):
    """The reference's params (numpy), forward ``(logits, aux)`` and, with
    ``cache_len``, the decode logits and state after ``STEPS`` steps."""
    key = (name, dtype, cache_len)
    if key not in _REF:
        cfg, _ = cfg_pair(name, dtype)
        m = j_build(cfg)
        params = m.init(jax.random.PRNGKey(0))
        batch, steps = inputs(cfg)
        out = dict(params=jax.tree.map(np.asarray, params))
        if cache_len is None:
            lg, aux = jax.jit(m.forward)(params, to_jax(batch))
            out.update(logits=np.asarray(lg, np.float32), aux=float(aux))
        else:
            st = m.init_decode_state(B, cache_len)
            out["state0"] = jax.tree.map(np.asarray, st)
            dec = jax.jit(m.decode_step)
            lgs = []
            for d in steps:
                lg, st = dec(params, st, to_jax(d))
                lgs.append(np.asarray(lg, np.float32))
            out.update(logits=lgs, state=jax.tree.map(np.asarray, st))
        _REF[key] = out
    return _REF[key]


def port_model(name, dtype, params):
    _, cfg = cfg_pair(name, dtype)
    return interop.lm_params_from_reference(build_model(cfg, device="cpu"),
                                            params)


@torch.no_grad()
def check_forward(name, dtype="float32"):
    want = reference(name, dtype)
    cfg, _ = cfg_pair(name, dtype)
    model = port_model(name, dtype, want["params"])
    batch, _ = inputs(cfg)
    lg, aux = model(to_torch(batch))
    tol = TOL if dtype == "float32" else BF16_TOL
    assert str(lg.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(lg.float().numpy(), want["logits"], **tol)
    np.testing.assert_allclose(float(aux), want["aux"], **tol)


@torch.no_grad()
def check_decode(name, cache_len):
    """``STEPS`` decode steps from the reference's fresh state (carried
    across): every step's logits and the final state."""
    want = reference(name, cache_len=cache_len)
    cfg, _ = cfg_pair(name)
    model = port_model(name, "float32", want["params"])
    _, steps = inputs(cfg)
    st = interop.lm_state_from_reference(want["state0"], "cpu")
    for d, lg_want in zip(steps, want["logits"], strict=True):
        lg, st = model.decode_step(st, to_torch(d))
        np.testing.assert_allclose(lg.numpy(), lg_want, **TOL)
    got = interop.lm_state_to_reference(st)
    assert set(got) == set(want["state"])
    for k in got:
        gl, wl = jax.tree.leaves(got[k]), jax.tree.leaves(want["state"][k])
        assert len(gl) == len(wl), k
        for g, w in zip(gl, wl):
            assert g.shape == w.shape, k
            np.testing.assert_allclose(g, np.asarray(w, g.dtype), **TOL)


@torch.no_grad()
def check_decode_matches_forward(name):
    """The port alone, as ``test_archs_smoke.py::test_decode_matches_forward``
    holds the reference: 12 stepwise decode steps reproduce the full
    forward's last logits (float32; MoE undropped, capacity 8), here
    within 1e-4 against the reference's 2e-2."""
    _, cfg = cfg_pair(name)
    if cfg.moe:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    model = build_model(cfg, device="cpu", seed=1)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, 12)))
    lg_full, _ = model({"tokens": toks})
    st = model.init_decode_state(B, 32, dtype=torch.float32)
    for i in range(12):
        lg_step, st = model.decode_step(st, {"tokens": toks[:, i: i + 1]})
    np.testing.assert_allclose(lg_step[:, 0].numpy(), lg_full[:, -1].numpy(),
                               **TOL)


def check_config(name):
    """Every field of the arch and of its reduced form, and the analytic
    parameter counts, equal the reference's."""
    for ref, port in ((ARCHS[name], tcfg.ARCHS[name]),
                      (reduced(ARCHS[name]), tcfg.reduced(tcfg.ARCHS[name]))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.resolved_head_dim == ref.resolved_head_dim
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
    assert (name in tcfg.LONG_CONTEXT_OK) == (name in LONG_CONTEXT_OK)
    assert {k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in SHAPES.items()}
