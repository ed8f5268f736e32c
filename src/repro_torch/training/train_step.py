"""Train step: loss, gradient accumulation over microbatches, optimizer
(port of ``repro.training.train_step``).

The model's forward is rematerialised per layer unit when ``cfg.remat``
holds (``models.model.forward``).  Each microbatch's gradients are taken
with ``torch.autograd.grad`` and added into explicit accumulators of
``accum_dtype``, as the reference's scan does (``.grad`` would accumulate
in the parameters' dtype).  The parameters are updated in place under
``no_grad``.  Sharded accumulators and optimizer states wait for the
port of ``parallel/``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import device_const
from repro_torch.models import model as model_mod

from .optimizer import AdamWConfig, AdamWState, adamw_update

IGNORE_LABEL = -100


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1            # gradient-accumulation steps
    aux_loss_weight: float = 0.01    # MoE load-balancing loss
    accum_dtype: str = "float32"     # grad accumulator ("bfloat16" lean)
    opt: AdamWConfig = field(default_factory=AdamWConfig)


def loss_fn(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over non-ignored labels.  logits [..., V], labels [...]
    int with ``IGNORE_LABEL`` masked out (gathered at ``max(label, 0)``).
    float32 math."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    safe = torch.clamp_min(labels, 0).long()
    picked = torch.gather(lg, -1, safe[..., None])[..., 0]
    mask = labels != IGNORE_LABEL
    ce = torch.where(mask, lse - picked, 0.0)
    return ce.sum() / torch.clamp_min(mask.sum(), 1)


def _microbatch_loss(model, mb, cfg: ModelConfig, tc: TrainConfig):
    logits, aux = model_mod.forward(model, mb, cfg)
    loss = loss_fn(logits, mb["labels"])
    return loss + tc.aux_loss_weight * aux, (loss, aux)


def split_microbatches(batch: dict, n: int) -> list[dict]:
    """Split every leaf's batch dim into ``n`` equal microbatches; the
    M-RoPE positions carry the batch on dim 1 (``[3, B, S]``)."""
    out = {}
    for k, v in batch.items():
        dim = 1 if k == "mrope_pos" else 0
        if v.shape[dim] % n:
            raise ValueError(f"{k}: batch {v.shape[dim]} not divisible by "
                             f"{n} microbatches")
        out[k] = v.chunk(n, dim=dim)
    return [{k: v[i] for k, v in out.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """Returns ``train_step(model, opt_state, batch) -> (opt_state',
    metrics)``.  ``batch`` leaves have a leading global-batch dim, split
    into ``tc.microbatches`` accumulation steps; ``model``'s parameters
    are made trainable and updated in place.  ``metrics``: loss, aux_loss,
    lr, grad_norm (float32 tensors)."""
    acc_dt = torch.bfloat16 if tc.accum_dtype == "bfloat16" else torch.float32
    n = tc.microbatches

    def train_step(model, opt_state: AdamWState, batch):
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        dev = model.device
        gsum = {k: torch.zeros(p.shape, dtype=acc_dt, device=dev)
                for k, p in params.items()}
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        asum = torch.zeros((), dtype=torch.float32, device=dev)
        for mb in split_microbatches(batch, n):
            tot, (loss, aux) = _microbatch_loss(model, mb, cfg, tc)
            grads = torch.autograd.grad(tot, list(params.values()),
                                        allow_unused=True)
            for k, g in zip(params, grads):
                if g is not None:      # an unused parameter's grad is 0
                    gsum[k] = gsum[k] + g.to(acc_dt)
            lsum = lsum + loss.detach()
            asum = asum + aux.detach()
        nf = device_const(float(n), torch.float32, dev)
        grads = {k: g / nf.to(g.dtype) for k, g in gsum.items()}
        del gsum
        new_p, new_opt, om = adamw_update(params, grads, opt_state, tc.opt)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new_p[k])
        return new_opt, dict(loss=lsum / nf, aux_loss=asum / nf, **om)

    return train_step
