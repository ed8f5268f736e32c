"""Train step: loss, gradient accumulation over microbatches, optimizer
(port of ``repro.training.train_step``).

The model's forward is rematerialised per layer unit when ``cfg.remat``
holds (``models.model.forward``).  Each microbatch's gradients are taken
with ``torch.autograd.grad`` and added into explicit accumulators of
``accum_dtype``, as the reference's scan does (``.grad`` would accumulate
in the parameters' dtype).  The parameters are updated in place under
``no_grad``.

Sharded (``ctx`` given): the parameters, the AdamW moments and the batch
are DTensors on ``ctx.mesh``; the accumulators are DTensors too, in the
layout ``accum_shardings`` names (the ZeRO placements of
``parallel.param_specs.opt_state_specs``), and each microbatch's
gradients are redistributed into it (a reduce-scatter where a replicated
parameter's gradient is a pending sum), as the reference constrains its
accumulators.  The step runs under ``implicit_replication()``: the
positions, masks and scalars it builds are the same on every rank.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import device_const
from repro_torch.models import model as model_mod
from repro_torch.parallel.sharding import even_placements, with_sharding

from .optimizer import AdamWConfig, AdamWState, adamw_update

IGNORE_LABEL = -100


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1            # gradient-accumulation steps
    aux_loss_weight: float = 0.01    # MoE load-balancing loss
    accum_dtype: str = "float32"     # grad accumulator ("bfloat16" lean)
    opt: AdamWConfig = field(default_factory=AdamWConfig)


def loss_fn(logits: torch.Tensor, labels: torch.Tensor,
            ctx=None) -> torch.Tensor:
    """Mean CE over non-ignored labels.  logits [..., V] (vocab-sharded
    with ``ctx``), labels [...] int with ``IGNORE_LABEL`` masked out
    (gathered at ``max(label, 0)``).  float32 math."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    safe = torch.clamp_min(labels, 0).long()
    picked = torch.gather(lg, -1, safe[..., None])
    # A gather from vocab-sharded logits is a masked partial sum; DTensor
    # reduces it only while it keeps the gather's shape, so it is placed
    # batch-sharded before the trailing 1 is dropped.
    picked = with_sharding(ctx, picked, "batch",
                           *([None] * (picked.ndim - 1)))[..., 0]
    mask = labels != IGNORE_LABEL
    ce = torch.where(mask, lse - picked, 0.0)
    return ce.sum() / torch.clamp_min(mask.sum(), 1)


def _microbatch_loss(model, mb, cfg: ModelConfig, tc: TrainConfig,
                     ctx=None):
    logits, aux = model_mod.forward(model, mb, cfg, ctx)
    loss = loss_fn(logits, mb["labels"], ctx)
    return loss + tc.aux_loss_weight * aux, (loss, aux)


def _chunks(v: torch.Tensor, n: int, dim: int):
    """``v.chunk(n, dim)``: microbatch i holds the global rows
    [i*b/n, (i+1)*b/n), as the reference's reshape.  A DTensor sharded on
    ``dim`` is gathered on it first and each microbatch resharded to
    ``v``'s placements (an all-gather of the batch, then local slices),
    but replicated over a mesh dim that would split its rows unevenly
    (16 rows over 2 x 16 ranks: DTensor then flattens the batch with the
    wrong local shapes)."""
    if not isinstance(v, DTensor):
        return v.chunk(n, dim=dim)
    mesh, pl = v.device_mesh, v.placements
    whole = v.redistribute(mesh, [Replicate() if q.is_shard(dim) else q
                                  for q in pl])
    return [c.redistribute(mesh, even_placements(pl, c.shape, mesh))
            for c in whole.chunk(n, dim=dim)]


def split_microbatches(batch: dict, n: int) -> list[dict]:
    """Split every leaf's batch dim into ``n`` equal microbatches; the
    M-RoPE positions carry the batch on dim 1 (``[3, B, S]``)."""
    out = {}
    for k, v in batch.items():
        dim = 1 if k == "mrope_pos" else 0
        if v.shape[dim] % n:
            raise ValueError(f"{k}: batch {v.shape[dim]} not divisible by "
                             f"{n} microbatches")
        out[k] = _chunks(v, n, dim)
    return [{k: v[i] for k, v in out.items()} for i in range(n)]


def _zeros_like_layout(p: torch.Tensor, dtype, placements):
    """Zeros of ``p``'s global shape in ``dtype``: a DTensor on ``p``'s
    mesh in ``placements`` (``p``'s own when None) if ``p`` is one."""
    if not isinstance(p, DTensor):
        return torch.zeros(p.shape, dtype=dtype, device=p.device)
    # the accumulator layouts only add axes to the parameter's: a local
    # split, no collective
    local = p.detach().redistribute(p.device_mesh, placements or p.placements)
    return torch.zeros_like(local, dtype=dtype)


def _to_layout(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` in ``like``'s placements (the identity on plain tensors)."""
    if isinstance(like, DTensor):
        return x.redistribute(like.device_mesh, like.placements)
    return x


def make_train_step(cfg: ModelConfig, tc: TrainConfig, ctx=None,
                    accum_shardings: dict | None = None):
    """Returns ``train_step(model, opt_state, batch) -> (opt_state',
    metrics)``.  ``batch`` leaves have a leading global-batch dim, split
    into ``tc.microbatches`` accumulation steps; ``model``'s parameters
    are made trainable and updated in place.  ``metrics``: loss, aux_loss,
    lr, grad_norm (float32 tensors).

    ``ctx``: a ``parallel.ShardingCtx`` over a ``DeviceMesh`` (the model
    is then one of DTensors).  ``accum_shardings``: parameter name ->
    DTensor placements of its gradient accumulator on ``ctx.mesh``;
    without it an accumulator takes its parameter's placements."""
    acc_dt = torch.bfloat16 if tc.accum_dtype == "bfloat16" else torch.float32
    n = tc.microbatches
    acc_pl = accum_shardings or {}

    def train_step(model, opt_state: AdamWState, batch):
        with (implicit_replication() if ctx is not None
              else contextlib.nullcontext()):
            return _step(model, opt_state, batch)

    def _step(model, opt_state, batch):
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        dev = model.device
        gsum = {k: _zeros_like_layout(p, acc_dt, acc_pl.get(k))
                for k, p in params.items()}
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        asum = torch.zeros((), dtype=torch.float32, device=dev)
        for mb in split_microbatches(batch, n):
            tot, (loss, aux) = _microbatch_loss(model, mb, cfg, tc, ctx)
            grads = torch.autograd.grad(tot, list(params.values()),
                                        allow_unused=True)
            for k, g in zip(params, grads):
                if g is not None:      # an unused parameter's grad is 0
                    gsum[k] = gsum[k] + _to_layout(g.to(acc_dt), gsum[k])
            lsum = lsum + loss.detach()
            asum = asum + aux.detach()
        nf = device_const(float(n), torch.float32, dev)
        grads = {k: g / nf.to(g.dtype) for k, g in gsum.items()}
        del gsum
        new_p, new_opt, om = adamw_update(params, grads, opt_state, tc.opt)
        new_opt = new_opt._replace(
            mu={k: _to_layout(v, opt_state.mu[k])
                for k, v in new_opt.mu.items()},
            nu={k: _to_layout(v, opt_state.nu[k])
                for k, v in new_opt.nu.items()})
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(_to_layout(new_p[k], p))
        return new_opt, dict(loss=lsum / nf, aux_loss=asum / nf, **om)

    return train_step
