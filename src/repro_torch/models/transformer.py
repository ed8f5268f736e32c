"""Block composition: pre-norm residual blocks for every family (port of
``repro.models.transformer``).

Families map to repeating units of per-layer modules, looped in order:

  dense / audio / vlm   unit = [attn, mlp]                        x L
  moe                   unit = [attn, moe] (first k layers dense) x L
  ssm (xlstm)           unit = [mLSTM x (k-1), sLSTM]             x L/k
  hybrid (zamba2)       unit = [mamba x (k-1), shared-attn+mamba] x L/k

The reference stacks each unit's parameters and scans them
(``scan_layers``, ``stacked_init``), with ``jax.checkpoint`` for training;
here each layer is its own module in an ``nn.ModuleList`` and the model
loops over them; with ``cfg.remat`` and grad enabled it checkpoints each
unit (``model._scan``), as the reference remats its scan body.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.parallel.sharding import with_sharding

from . import attention as attn
from . import moe as moe_mod
from .layers import MLP, Init, RMSNorm, mlp, rmsnorm


class AttnMLPBlock(nn.Module):
    def __init__(self, init: Init, cfg, dtype, use_moe: bool):
        super().__init__()
        self.ln1 = RMSNorm(init, cfg.d_model, dtype)
        self.attn = (attn.MLA(init, cfg, dtype) if cfg.attn_type == "mla"
                     else attn.GQA(init, cfg, dtype))
        self.ln2 = RMSNorm(init, cfg.d_model, dtype)
        self.ffn = (moe_mod.MoE(init, cfg, dtype) if use_moe
                    else MLP(init, cfg.d_model, cfg.d_ff, dtype))


def attn_mlp_forward(x, blk, cfg, pos, use_moe: bool, mrope_pos=None,
                     ctx=None):
    """Pre-norm attn + (mlp|moe).  Returns (x, kv, aux_loss).

    With ``ctx`` both residual sums take the layer boundary's layout
    (``("batch", "seq", None)``): left free, DTensor reduce-scatters the
    sublayers' partial sums onto the sequence dim, and torch 2.11 cannot
    then flatten (batch, seq) for the next matmul."""
    h = rmsnorm(x, blk.ln1, cfg.norm_eps)
    if cfg.attn_type == "mla":
        a, kv = attn.mla_forward(h, blk.attn, cfg, pos)
    else:
        a, kv = attn.gqa_forward(h, blk.attn, cfg, pos, mrope_pos=mrope_pos)
    x = with_sharding(ctx, x + a, "batch", "seq", None)
    h = rmsnorm(x, blk.ln2, cfg.norm_eps)
    if use_moe:
        f, stats = moe_mod.moe_layer(h, blk.ffn, cfg, ctx)
        aux = stats.aux_loss
    else:
        f = mlp(h, blk.ffn)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return with_sharding(ctx, x + f, "batch", "seq", None), kv, aux


def attn_mlp_decode(x, blk, cfg, cache, cache_len, pos, use_moe: bool,
                    mrope_pos=None):
    """One-token pre-norm block; ``cache`` is written in place.  Returns
    (x, cache)."""
    h = rmsnorm(x, blk.ln1, cfg.norm_eps)
    if cfg.attn_type == "mla":
        a, (c0, c1, _) = attn.mla_decode(
            h, blk.attn, cfg, cache[0], cache[1], cache_len, pos)
    else:
        a, (c0, c1, _) = attn.gqa_decode(
            h, blk.attn, cfg, cache[0], cache[1], cache_len, pos,
            mrope_pos=mrope_pos)
    x = x + a
    h = rmsnorm(x, blk.ln2, cfg.norm_eps)
    f = (moe_mod.moe_layer(h, blk.ffn, cfg)[0] if use_moe
         else mlp(h, blk.ffn))
    return x + f, (c0, c1)
