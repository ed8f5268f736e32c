"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, truly recurrent), for xlstm-1.3b (port of
``repro.models.xlstm``).

mLSTM uses exponential input gating and sigmoid forget gating with the
log-domain stabilizer ``m``; prefill runs the chunkwise algorithm
(quadratic within a chunk, recurrent across chunks), decode runs the O(1)
recurrence on the (C, n, m) state.

sLSTM has a genuine hidden-state recurrence (R h_{t-1} enters the gates),
so it loops over time; its state is per-head scalar memory (c, n, m, h).
The reference's ``_barrier`` (an XLA scheduling fence, the identity in the
forward pass) has no counterpart.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.launch.hlo_analysis import recurrence

from .layers import (GroupNorm, Init, Linear, gather_dim, groupnorm_heads,
                     linear)


class MLSTMState(NamedTuple):
    c: torch.Tensor   # [B, H, dk, dv] matrix memory
    n: torch.Tensor   # [B, H, dk]
    m: torch.Tensor   # [B, H]


class SLSTMState(NamedTuple):
    c: torch.Tensor   # [B, H, dh]
    n: torch.Tensor   # [B, H, dh]
    m: torch.Tensor   # [B, H, dh]
    h: torch.Tensor   # [B, H, dh]


def mlstm_dims(cfg):
    d_inner = int(cfg.d_model * cfg.xlstm.proj_factor)
    heads = cfg.num_heads
    return d_inner, heads, d_inner // heads


def mlstm_state0(b, heads, dh, device) -> MLSTMState:
    f32 = torch.float32
    return MLSTMState(
        c=torch.zeros((b, heads, dh, dh), dtype=f32, device=device),
        n=torch.zeros((b, heads, dh), dtype=f32, device=device),
        m=torch.full((b, heads), -1e30, dtype=f32, device=device))


def slstm_state0(b, heads, dh, device) -> SLSTMState:
    f32 = torch.float32
    return SLSTMState(
        c=torch.zeros((b, heads, dh), dtype=f32, device=device),
        n=torch.full((b, heads, dh), 1e-6, dtype=f32, device=device),
        m=torch.full((b, heads, dh), -1e30, dtype=f32, device=device),
        h=torch.zeros((b, heads, dh), dtype=f32, device=device))


class MLSTMBlock(nn.Module):
    def __init__(self, init: Init, cfg, dtype):
        super().__init__()
        d = cfg.d_model
        d_inner, heads, dh = mlstm_dims(cfg)
        self.up_x = Linear(init, d, d_inner, dtype=dtype)
        self.up_g = Linear(init, d, d_inner, dtype=dtype)
        self.wq = Linear(init, d_inner, d_inner, dtype=dtype)
        self.wk = Linear(init, d_inner, d_inner, dtype=dtype)
        self.wv = Linear(init, d_inner, d_inner, dtype=dtype)
        self.wi = Linear(init, d_inner, heads, dtype=torch.float32)
        self.wf = Linear(init, d_inner, heads, dtype=torch.float32)
        self.gn = GroupNorm(init, heads, dh, dtype)
        self.down = Linear(init, d_inner, d, dtype=dtype)


def _mlstm_chunk(q, k, v, li, lf, state: MLSTMState):
    """One chunk of the chunkwise mLSTM.

    q,k,v: [B,L,H,dk/dv]; li/lf: [B,L,H] log input/forget gates.
    Returns (h [B,L,H,dv], new state).  All math in float32.
    """
    b, l, h, dk = q.shape
    lf_cum = torch.cumsum(lf, dim=1)                              # [B,L,H]
    # intra-chunk log weights: D[t,s] = lf_cum[t] - lf_cum[s] + li[s], s<=t
    dmat = lf_cum[:, :, None, :] - lf_cum[:, None, :, :] + li[:, None, :, :]
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                   device=q.device))
    dmat = torch.where(causal[None, :, :, None], dmat, -torch.inf)
    # stabilizer per (b, t, h)
    m_intra = dmat.amax(dim=2)                                    # [B,L,H]
    m_inter = state.m[:, None, :] + lf_cum                        # [B,L,H]
    m_t = torch.maximum(m_intra, m_inter)
    d_exp = torch.exp(dmat - m_t[:, :, None, :])                  # [B,L,L,H]

    qk = torch.einsum("blhd,bshd->blsh", q, k) * (dk ** -0.5)     # [B,L,S,H]
    w = qk * d_exp
    h_intra = torch.einsum("blsh,bshv->blhv", w, v)
    denom_intra = torch.einsum("blsh,bsh->blh", w, torch.ones_like(li))
    # carried-state contribution
    scale_inter = torch.exp(m_inter - m_t)                        # [B,L,H]
    h_inter = torch.einsum("blhd,bhdv->blhv", q, state.c) * \
        scale_inter[..., None] * (dk ** -0.5)
    denom_inter = torch.einsum("blhd,bhd->blh", q, state.n) * scale_inter \
        * (dk ** -0.5)

    denom = torch.maximum(torch.abs(denom_intra + denom_inter),
                          torch.exp(-m_t))
    h_out = (h_intra + h_inter) / denom[..., None]

    # state update to end of chunk
    lf_tot = lf_cum[:, -1, :]                                     # [B,H]
    m_state_intra = (lf_tot[:, None, :] - lf_cum + li).amax(dim=1)
    m_new = torch.maximum(state.m + lf_tot, m_state_intra)
    w_state = torch.exp(lf_tot[:, None, :] - lf_cum + li - m_new[:, None, :])
    kw = k * w_state[..., None]                                   # [B,S,H,dk]
    c_new = (state.c * torch.exp(state.m + lf_tot - m_new)[..., None, None]
             + torch.einsum("bshd,bshv->bhdv", kw, v))
    n_new = (state.n * torch.exp(state.m + lf_tot - m_new)[..., None]
             + torch.einsum("bsh,bshd->bhd", w_state, k))
    return h_out, MLSTMState(c=c_new, n=n_new, m=m_new)


def _batch_sharded(y):
    """A DTensor with its batch dim (0) as it is and every other mesh dim
    replicated: a partial sum reduced, a sharded dim gathered.  Left to
    DTensor, the mLSTM's partial sums (``wq``, ``wk``, ``wi``, ``wf``
    contract a sharded dim) are reduce-scattered onto the sequence dim,
    which the chunk loop then slices, and ``wv``'s output is sharded on
    the value dim, which the head split cannot keep (DTensor splits a
    sharded dim only on its outer factor)."""
    if not isinstance(y, DTensor):
        return y
    return y.redistribute(y.device_mesh, [
        p if p.is_shard(0) else Replicate() for p in y.placements])


def _merge_heads(h):
    """[B, S, H, dh] -> [B, S, H*dh].  A DTensor over a mesh dim whose
    size does not divide H is made whole in (H, dh) first (the group
    norm shards dh, a merge torch 2.11 refuses), and the merged result is
    pinned to its own layout: the gradient that comes back sharded on
    the merged dim could not be split into (H, dh) again."""
    b, s, heads, dh = h.shape
    if not (isinstance(h, DTensor) and any(
            heads % n for n in h.device_mesh.shape)):
        return h.reshape(b, s, heads * dh)
    h = gather_dim(gather_dim(h, 3), 2)
    y = h.reshape(b, s, heads * dh)
    return y.redistribute(y.device_mesh, y.placements)


def _mlstm_qkv_gates(x, p, heads, dh):
    b, s = x.shape[:2]
    xi, gate = linear(x, p.up_x), linear(x, p.up_g)
    q, k, v = (_batch_sharded(linear(xi, w)).reshape(b, s, heads, dh).float()
               for w in (p.wq, p.wk, p.wv))
    li = F.logsigmoid(_batch_sharded(linear(xi, p.wi)).float() + 4.0)
    lf = F.logsigmoid(_batch_sharded(linear(xi, p.wf)).float() + 4.0)
    return gate, q, k, v, li, lf


def mlstm_forward(x, p, cfg, state: MLSTMState | None = None):
    """Full-sequence mLSTM block.  x: [B,S,d]."""
    b, s, d = x.shape
    _, heads, dh = mlstm_dims(cfg)
    gate, q, k, v, li, lf = _mlstm_qkv_gates(x, p, heads, dh)

    ch = min(cfg.xlstm.chunk, s)
    n_chunks = (s + ch - 1) // ch
    pad = n_chunks * ch - s
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        li, lf = (F.pad(t, (0, 0, 0, pad)) for t in (li, lf))
        # padded forget gates must not decay the state: set lf=0, li=-inf
        valid = torch.arange(n_chunks * ch, device=x.device) < s
        li = torch.where(valid[None, :, None], li, -1e30)
        lf = torch.where(valid[None, :, None], lf, 0.0)

    st = state if state is not None else mlstm_state0(b, heads, dh, x.device)
    hs = []
    for c in range(n_chunks):
        sl = slice(c * ch, (c + 1) * ch)
        h, st = _mlstm_chunk(q[:, sl], k[:, sl], v[:, sl], li[:, sl],
                             lf[:, sl], st)
        hs.append(h)
    h = torch.cat(hs, dim=1)[:, :s]
    h = _merge_heads(groupnorm_heads(h.to(x.dtype), p.gn)) * F.silu(gate)
    return linear(h, p.down), st


def mlstm_decode(x, p, cfg, state: MLSTMState):
    """O(1) recurrent step.  x: [B,1,d]."""
    _, heads, dh = mlstm_dims(cfg)
    gate, q, k, v, li, lf = _mlstm_qkv_gates(x, p, heads, dh)
    q, k, v, li, lf = q[:, 0], k[:, 0], v[:, 0], li[:, 0], lf[:, 0]

    m_new = torch.maximum(state.m + lf, li)                       # [B,H]
    fs = torch.exp(state.m + lf - m_new)[..., None]
    is_ = torch.exp(li - m_new)[..., None]
    c_new = state.c * fs[..., None] \
        + is_[..., None] * k[..., None] * v[:, :, None, :]
    n_new = state.n * fs + is_ * k
    qn = q * (dh ** -0.5)
    num = torch.einsum("bhd,bhdv->bhv", qn, c_new)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qn, n_new)),
                        torch.exp(-m_new))[..., None]
    h = (num / den).to(x.dtype)[:, None]                          # [B,1,H,dv]
    h = _merge_heads(groupnorm_heads(h, p.gn)) * F.silu(gate)
    return linear(h, p.down), MLSTMState(c=c_new, n=n_new, m=m_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
class SLSTMBlock(nn.Module):
    def __init__(self, init: Init, cfg, dtype):
        super().__init__()
        d, heads = cfg.d_model, cfg.num_heads
        dh = d // heads
        ff = int(d * 4 / 3)
        self.wx = Linear(init, d, (4, heads, dh), dtype=dtype)    # i,f,z,o
        self.r = init.normal((4, heads, dh, dh), 0.02, dtype)
        self.b = init.full((4, heads, dh), 0.0, torch.float32)
        self.gn = GroupNorm(init, heads, dh, dtype)
        self.ff_up = Linear(init, d, 2 * ff, dtype=dtype)
        self.ff_down = Linear(init, ff, d, dtype=dtype)


def _slstm_cell(gates_x, st: SLSTMState, r_w):
    """gates_x: [B,4,H,dh] (from x); recurrence adds R h_{t-1}."""
    rec = torch.einsum("bhd,ghde->bghe", st.h, r_w)               # [B,4,H,dh]
    g = (gates_x + rec).float()
    li = g[:, 0]                    # input gate (exp) pre-activation
    lf = F.logsigmoid(g[:, 1])      # forget gate (sigmoid, log domain)
    z = torch.tanh(g[:, 2])
    o = torch.sigmoid(g[:, 3])
    m_new = torch.maximum(lf + st.m, li)
    i_s = torch.exp(li - m_new)
    f_s = torch.exp(lf + st.m - m_new)
    c_new = f_s * st.c + i_s * z
    n_new = torch.clamp_min(f_s * st.n + i_s, 1e-6)
    h_new = o * (c_new / n_new)
    return SLSTMState(c=c_new, n=n_new, m=m_new, h=h_new)


def slstm_forward(x, p, cfg, state: SLSTMState | None = None,
                  time_chunk: int = 64):
    """Sequence loop (sLSTM is inherently recurrent).  x: [B,S,d].

    Like the reference, a sequence longer than ``time_chunk`` and not a
    multiple of it is padded with zero gates to whole chunks, and the final
    state is the one after the padded steps."""
    b, s, d = x.shape
    heads = cfg.num_heads
    dh = d // heads
    gates = linear(x, p.wx) + p.b.to(x.dtype)                     # [B,S,4,H,dh]
    st = state if state is not None else slstm_state0(b, heads, dh, x.device)
    r_w = p.r.float()
    tc = min(time_chunk, s)
    n_steps = (s + tc - 1) // tc * tc
    if n_steps > s:
        gates = F.pad(gates, (0, 0, 0, 0, 0, 0, 0, n_steps - s))
    hs = []
    for t in recurrence(n_steps):
        st = _slstm_cell(gates[:, t], st, r_w)
        hs.append(st.h)
    # a dry run's op trace runs a stretch of the steps and counts the
    # others by the trip count (hlo_analysis.by_trip_count); their
    # outputs stay unwritten.  Every step runs otherwise.
    hs += [torch.empty_like(st.h)] * (s - len(hs))
    h = torch.stack(hs[:s], dim=1)                                # [B,S,H,dh]
    h = _merge_heads(groupnorm_heads(h.to(x.dtype), p.gn))
    up = linear(h, p.ff_up)
    ff = up.shape[-1] // 2
    y = F.gelu(up[..., :ff], approximate="tanh") * up[..., ff:]
    return linear(y, p.ff_down), st


def slstm_decode(x, p, cfg, state: SLSTMState):
    return slstm_forward(x, p, cfg, state)
