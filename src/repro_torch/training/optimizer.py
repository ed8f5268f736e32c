"""AdamW over a model's named parameters (port of
``repro.training.optimizer``).

A parameter tree here is a dict ``name -> tensor`` (``dict(
model.named_parameters())``: one leaf per layer where the reference stacks
layers); ``mu`` and ``nu`` are dicts with the same names.  The arithmetic
is the reference's, in float32 and in its order: global-norm clipping,
linear warmup then cosine decay, decoupled weight decay, moments stored in
``state_dtype`` (``'bfloat16'`` for lean states).  Scalars that XLA folds
into a float32 operand are float32 tensors here (``device_const``): torch
divides a Python scalar by a tensor as a reciprocal times the scalar, and
on the card divides a tensor by a Python scalar the same way.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.core.types import device_const
from repro_torch.interop import STACKED

F32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"     # or "bfloat16" for lean states


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32[]
    mu: dict             # name -> tensor, like the params
    nu: dict


def _state_dt(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.state_dtype == "bfloat16" else F32


def adamw_init(params: dict, cfg: AdamWConfig) -> AdamWState:
    """Zero moments in ``state_dtype`` beside each parameter; step 0 on the
    parameters' device."""
    dt = _state_dt(cfg)
    dev = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu={k: torch.zeros(p.shape, dtype=dt, device=p.device)
            for k, p in params.items()},
        nu={k: torch.zeros(p.shape, dtype=dt, device=p.device)
            for k, p in params.items()})


def schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Learning rate at ``step`` (an int32 tensor): linear warmup to
    ``cfg.lr``, then cosine decay to ``min_lr_frac * lr``."""
    dev = step.device
    s = step.float()
    warm = torch.clamp_max(
        s / device_const(float(max(cfg.warmup_steps, 1)), F32, dev), 1.0)
    span = float(max(cfg.total_steps - cfg.warmup_steps, 1))
    t = torch.clamp((step - cfg.warmup_steps).float()
                    / device_const(span, F32, dev), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def reference_order(name: str):
    """Sort key that visits per-layer leaves in the reference's leaf
    order: its sorted dict path (the name without layer indices), then the
    layer indices of its stacked leading axes (a stacked leaf,
    ``interop.STACKED``, by its path alone)."""
    parts = name.removeprefix(STACKED).split(".")
    return ([p for p in parts if not p.isdigit()],
            [int(p) for p in parts if p.isdigit()])


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the float32 sum of squares, leaf by leaf in the reference's
    leaf order.  A stacked reference leaf is one sum over all its layers;
    here each layer is summed alone, so the result may sit an ulp or two
    off the reference's."""
    keys = sorted(tree, key=reference_order)
    return torch.sqrt(sum(torch.sum(torch.square(tree[k].float()))
                          for k in keys))


def adamw_update(params: dict, grads: dict, st: AdamWState,
                 cfg: AdamWConfig):
    """One AdamW step.  Returns ``(new_params, new_state, metrics)``; new
    parameters keep each parameter's dtype, moments ``state_dtype``."""
    step = st.step + 1
    dev = step.device
    lr = schedule(step, cfg)
    gnorm = global_norm(grads)
    scale = torch.clamp_max(device_const(float(cfg.clip_norm), F32, dev)
                            / torch.clamp_min(gnorm, 1e-9), 1.0)
    dt = _state_dt(cfg)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.float()
    bc1 = 1 - torch.pow(device_const(b1, F32, dev), sf)
    bc2 = 1 - torch.pow(device_const(b2, F32, dev), sf)

    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float() * scale
        mu32 = st.mu[k].float() * b1 + (1 - b1) * g
        nu32 = st.nu[k].float() * b2 + (1 - b2) * g * g
        mhat = mu32 / bc1
        vhat = nu32 / bc2
        p32 = p.detach().float()
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        new_p[k] = (p32 - lr * delta).to(p.dtype)
        new_mu[k], new_nu[k] = mu32.to(dt), nu32.to(dt)
    return new_p, AdamWState(step=step, mu=new_mu, nu=new_nu), dict(
        lr=lr, grad_norm=gnorm)
