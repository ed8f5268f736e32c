"""Mamba2 (SSD) blocks for the hybrid architecture, zamba2 (port of
``repro.models.ssm``).

Chunked state-space-dual algorithm: within a chunk the recurrence is
evaluated in quadratic (attention-like) form; states are carried across
chunks by a loop.  Decode is the O(1) recurrent update.

Layout follows mamba2 with ngroups=1:
  in_proj: d -> (z | x | B | C | dt)   z,x: d_inner; B,C: state N; dt: heads
  causal depthwise conv over (x | B | C)
  y = SSD(x, dt, A, B, C) + D*x ; out = out_proj(y * silu(z))
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Init, Linear, einsum, linear


class SSMState(NamedTuple):
    h: torch.Tensor        # [B, H, dh, N] recurrent state
    conv_x: torch.Tensor   # [B, conv_width-1, d_inner] conv tail (x path)
    conv_bc: torch.Tensor  # [B, conv_width-1, 2N] conv tail (B/C path)


def ssm_dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    heads = s.num_heads or d_inner // s.head_dim
    return d_inner, heads, s.head_dim, s.state_dim


class Mamba2(nn.Module):
    """Projections split as (z | x | BC | dt), as the reference's."""

    def __init__(self, init: Init, cfg, dtype):
        super().__init__()
        d, s = cfg.d_model, cfg.ssm
        d_inner, heads, _, n = ssm_dims(cfg)
        f32 = torch.float32
        self.in_z = Linear(init, d, d_inner, dtype=dtype)
        self.in_x = Linear(init, d, d_inner, dtype=dtype)
        self.in_bc = Linear(init, d, 2 * n, dtype=dtype)
        self.in_dt = Linear(init, d, heads, dtype=dtype)
        self.conv_x_w = init.normal((s.conv_width, d_inner), 0.02, dtype)
        self.conv_x_b = init.full((d_inner,), 0.0, dtype)
        self.conv_bc_w = init.normal((s.conv_width, 2 * n), 0.02, dtype)
        self.conv_bc_b = init.full((2 * n,), 0.0, dtype)
        self.a_log = init.tensor(torch.log(
            torch.linspace(1.0, float(heads), heads, dtype=f32)))
        self.d_skip = init.full((heads,), 1.0, f32)
        self.dt_bias = init.full((heads,), 0.0, f32)
        self.out_proj = Linear(init, d_inner, d, dtype=dtype)
        self.norm_g = init.full((d_inner,), 1.0, dtype)


def _causal_conv(x, w, b, tail=None):
    """Depthwise causal conv: x [B,S,C], w [W,C].  tail: [B,W-1,C]
    history.  The taps are added to zero in order, as the reference's
    ``sum``."""
    width = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    out = 0
    for i in range(width):
        out = out + xp[:, i: i + x.shape[1], :] * w[i]
    new_tail = xp[:, -(width - 1):, :] if width > 1 else tail
    return F.silu(out + b), new_tail


def _gated_norm(y, z, g, eps=1e-5):
    y32 = (y * F.silu(z)).float()
    var = torch.mean(y32 * y32, dim=-1, keepdim=True)
    return (y32 * torch.rsqrt(var + eps)).to(y.dtype) * g


def _split_chunks(t, n_chunks, ch):
    """[B, n*ch, ...] -> [n, B, ch, ...]."""
    b = t.shape[0]
    return t.reshape(b, n_chunks, ch, *t.shape[2:]).transpose(0, 1)


def mamba2_forward(x, p, cfg, state: SSMState | None = None):
    """Full-sequence chunked SSD.  x: [B,S,d] -> (y, final SSMState)."""
    b, s, _ = x.shape
    d_inner, heads, dh, n = ssm_dims(cfg)
    f32 = torch.float32
    z = linear(x, p.in_z)
    xin = linear(x, p.in_x)
    bc = linear(x, p.in_bc)
    dt_raw = linear(x, p.in_dt)

    tail_x = None if state is None else state.conv_x
    tail_bc = None if state is None else state.conv_bc
    xin, tail_x2 = _causal_conv(xin, p.conv_x_w, p.conv_x_b, tail_x)
    bc_out, tail_bc2 = _causal_conv(bc, p.conv_bc_w, p.conv_bc_b, tail_bc)
    bmat, cmat = bc_out[..., :n], bc_out[..., n:]                # [B,S,N]

    dt = F.softplus(dt_raw.float() + p.dt_bias)                  # [B,S,H]
    a = -torch.exp(p.a_log)                                      # [H]
    xh = xin.reshape(b, s, heads, dh)

    ch = cfg.ssm.chunk
    n_chunks = (s + ch - 1) // ch
    pad = n_chunks * ch - s
    xp, dtp, bp, cp = xh, dt, bmat, cmat
    if pad:
        xp = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dtp, bp, cp = (F.pad(t, (0, 0, 0, pad)) for t in (dt, bmat, cmat))
    xc, dtc, bcs, ccs = (_split_chunks(t, n_chunks, ch)
                         for t in (xp, dtp, bp, cp))

    h = (torch.zeros((b, heads, dh, n), dtype=f32, device=x.device)
         if state is None else state.h)
    causal = torch.tril(torch.ones((ch, ch), dtype=torch.bool,
                                   device=x.device))
    ys = []
    for xk, dtk, bk, ck in zip(xc, dtc, bcs, ccs):
        da = dtk * a                            # [B,ch,H] log-decay per step
        cum = torch.cumsum(da, dim=1)           # [B,ch,H]
        # intra-chunk: L[i,j] = exp(cum_i - cum_j) for i>=j, masked before
        # the exp (the upper triangle can overflow)
        diff = cum[:, :, None, :] - cum[:, None, :, :]            # [B,i,j,H]
        l_mat = torch.exp(torch.where(causal[None, :, :, None], diff, -1e30))
        cb = einsum("bin,bjn->bij", ck, bk).float()               # [B,i,j]
        w = cb[..., None] * l_mat * dtk[:, None, :, :]            # [B,i,j,H]
        y_intra = einsum("bijh,bjhd->bihd", w, xk.float())
        # inter-chunk: contribution of the carried state
        y_inter = einsum("bin,bhdn->bihd", ck.float(), h) \
            * torch.exp(cum)[..., None]
        # state update: h' = exp(sum da) h + sum_j exp(cum_last - cum_j)
        # dt_j B_j x_j
        decay_all = torch.exp(cum[:, -1:, :])                     # [B,1,H]
        rev = torch.exp(cum[:, -1:, :] - cum) * dtk               # [B,ch,H]
        xw = xk.float() * rev[..., None]                          # [B,ch,H,dh]
        dh_new = einsum("bjn,bjhd->bhdn", bk.float(), xw)
        h = h * decay_all[:, 0, :, None, None] + dh_new
        ys.append(y_intra + y_inter)

    y = torch.stack(ys, dim=1).reshape(b, n_chunks * ch, heads, dh)[:, :s]
    y = y + xh.float() * p.d_skip[None, None, :, None]
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = _gated_norm(y, z, p.norm_g)
    out = linear(y, p.out_proj)
    return out, SSMState(h=h, conv_x=tail_x2, conv_bc=tail_bc2)


def mamba2_decode(x, p, cfg, state: SSMState):
    """Single-token recurrent update.  x: [B,1,d]."""
    b = x.shape[0]
    d_inner, heads, dh, n = ssm_dims(cfg)
    z = linear(x, p.in_z)
    xin = linear(x, p.in_x)
    bc = linear(x, p.in_bc)
    dt_raw = linear(x, p.in_dt)

    xin, tail_x2 = _causal_conv(xin, p.conv_x_w, p.conv_x_b, state.conv_x)
    bc_out, tail_bc2 = _causal_conv(bc, p.conv_bc_w, p.conv_bc_b,
                                    state.conv_bc)
    bvec = bc_out[:, 0, :n]                                      # [B,N]
    cvec = bc_out[:, 0, n:]
    dt = F.softplus(dt_raw[:, 0].float() + p.dt_bias)            # [B,H]
    a = -torch.exp(p.a_log)
    xh = xin[:, 0].reshape(b, heads, dh).float()

    decay = torch.exp(dt * a)                                    # [B,H]
    h_new = (state.h * decay[:, :, None, None]
             + dt[:, :, None, None] * xh[..., None] * bvec[:, None, None, :])
    y = einsum("bhdn,bn->bhd", h_new, cvec.float())
    y = y + xh * p.d_skip[None, :, None]
    y = y.reshape(b, 1, d_inner).to(x.dtype)
    y = _gated_norm(y, z, p.norm_g)
    return linear(y, p.out_proj), SSMState(h=h_new, conv_x=tail_x2,
                                           conv_bc=tail_bc2)
