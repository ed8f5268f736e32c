"""Mixture-of-Experts: top-k routing with capacity-bucketed dispatch
(port of ``repro.models.moe``).

Each (token, choice) pair takes its position within its expert's capacity
bucket from a one-hot running count; overflowing pairs are dropped
(standard capacity-factor semantics) and their tokens fall through on the
residual path.  The reference's three index sites keep its semantics:

* ``jax.lax.top_k``: ties go to the lower expert (a stable descending
  sort here; ``torch.topk`` promises no order among ties);
* the bucket scatter with ``mode='drop'`` and the gather with
  ``mode='fill'``: dropped pairs aim at one slot past the buckets, an
  extra row that is cut off (scatter) or zero (gather);
* ``.at[token_of].add``: the k weighted rows of a token are added to zero
  in choice order, as XLA's scatter applies them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.parallel.sharding import with_sharding

from .layers import MLP, Init, Linear, einsum, mlp


class MoEStats(NamedTuple):
    load: torch.Tensor      # float32[E] fraction of tokens per expert
    dropped: torch.Tensor   # float32[] fraction of (token,k) pairs dropped
    aux_loss: torch.Tensor  # float32[] load-balancing auxiliary loss


class MoE(nn.Module):
    def __init__(self, init: Init, cfg, dtype):
        super().__init__()
        d, e = cfg.d_model, cfg.moe
        self.router = Linear(init, d, e.num_experts, dtype=torch.float32)
        self.w_gate = init.normal((e.num_experts, d, e.d_ff_expert), 0.02,
                                  dtype)
        self.w_up = init.normal((e.num_experts, d, e.d_ff_expert), 0.02,
                                dtype)
        self.w_down = init.normal((e.num_experts, e.d_ff_expert, d), 0.02,
                                  dtype)
        if e.shared_experts:
            self.shared = MLP(init, d, e.d_ff_expert * e.shared_experts,
                              dtype)


def _bucket_rows(rows: torch.Tensor, dest: torch.Tensor, n: int):
    """``n`` zero rows with ``rows[i]`` written at ``dest[i]`` (the
    bucket scatter).  On DTensors it runs on every rank on the whole,
    replicated operands (torch 2.11's DTensor has no strategy for the
    in-place ``index_put_``), and the buckets come out replicated."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(rows, DTensor):
        buf = rows.new_zeros((n, rows.shape[1]))
        buf[dest] = rows
        return buf
    mesh, rep = rows.device_mesh, [Replicate()] * rows.device_mesh.ndim
    local = rows.redistribute(mesh, rep).to_local()
    buf = local.new_zeros((n, local.shape[1]))
    buf[dest.redistribute(mesh, rep).to_local()] = local
    return DTensor.from_local(buf, mesh, rep, run_check=False)


def moe_layer(x: torch.Tensor, p, cfg,
              ctx=None) -> tuple[torch.Tensor, MoEStats]:
    """x: [B, S, d] -> (out [B, S, d], stats)."""
    e = cfg.moe
    b, s, d = x.shape
    t, k, n_e = b * s, e.experts_per_token, e.num_experts
    xt = x.reshape(t, d)

    logits = xt.float() @ p.router.w                              # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]                     # [T, k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # capacity bucketing
    cap = max(int((t * k / n_e) * e.capacity_factor), 1)
    flat_e = top_i.reshape(-1)                                    # [T*k]
    onehot = F.one_hot(flat_e, n_e).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot).gather(
        1, flat_e[:, None])[:, 0]                                 # [T*k]
    keep = pos < cap
    dest = torch.where(keep, flat_e * cap + pos, n_e * cap)       # unique

    token_of = torch.arange(t, device=x.device).repeat_interleave(k)
    buf = _bucket_rows(xt[token_of], dest, n_e * cap + 1)
    buf = buf[:-1].reshape(n_e, cap, d)

    # expert FFN (einsum over the expert dim)
    h = einsum("ecd,edf->ecf", buf, p.w_gate)
    u = einsum("ecd,edf->ecf", buf, p.w_up)
    y = einsum("ecf,efd->ecd", F.silu(h) * u, p.w_down)
    y = torch.cat([y.reshape(n_e * cap, d), y.new_zeros((1, d))])

    gathered = y[dest]                                            # [T*k, d]
    wgt = torch.where(keep, top_p.reshape(-1), 0.0)[:, None].to(x.dtype)
    weighted = (gathered * wgt).reshape(t, k, d)
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + weighted[:, j]
    out = with_sharding(ctx, out, "batch", None)

    if e.shared_experts:
        out = out + mlp(xt, p.shared)

    load = onehot.sum(0).float() / max(t * k, 1)
    importance = probs.mean(0)
    aux = (load * importance).sum() * (n_e ** 2) / k
    stats = MoEStats(load=load, dropped=1.0 - keep.float().mean(),
                     aux_loss=aux.float())
    return out.reshape(b, s, d), stats
