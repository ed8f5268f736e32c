"""Attention: GQA (chunked online softmax + decode), sliding window, MLA
(port of ``repro.models.attention``).

Prefill and the full forward use the reference's online-softmax
formulation over KV chunks of ``cfg.attn_chunk_kv``, in plain torch ops
and in the reference's reduction order.  No hand-written kernel backs it
on either side: the reference's attention is plain ``jnp`` too.  Decode
attends one query position against the KV cache, which it writes in place.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from .layers import (Init, Linear, apply_mrope, apply_rope, einsum,
                     gather_dim, linear, sharded_inside, split_uneven)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# core: online-softmax attention over KV chunks
# ---------------------------------------------------------------------------
def chunked_attention(
    q: torch.Tensor,        # [B, S, H, dh]
    k: torch.Tensor,        # [B, T, Hkv, dh]
    v: torch.Tensor,        # [B, T, Hkv, dv]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: torch.Tensor | int = 0,   # absolute position of q[0]
    kv_chunk: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention, a loop over KV chunks.  Returns
    [B,S,H,dv].  KV heads are repeated to H inside the chunk body, one
    chunk at a time."""
    b, s, h, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hkv
    dev = q.device
    scale = scale if scale is not None else dh ** -0.5
    qs = q * scale

    kv_chunk = min(kv_chunk, t)
    n_chunks = (t + kv_chunk - 1) // kv_chunk
    pad = n_chunks * kv_chunk - t
    if pad:
        k = nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    q_pos = q_offset + torch.arange(s, device=dev)                  # [S]

    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, s, h, dv), dtype=v.dtype, device=dev)
    for c in range(n_chunks):
        kb = k[:, c * kv_chunk:(c + 1) * kv_chunk]
        vb = v[:, c * kv_chunk:(c + 1) * kv_chunk]
        if g > 1:  # repeat KV heads chunk-locally
            kb = kb.repeat_interleave(g, dim=2)
            vb = vb.repeat_interleave(g, dim=2)
        kv_pos = c * kv_chunk + torch.arange(kv_chunk, device=dev)  # [ckv]
        sc = einsum("bshd,bthd->bhst", qs, kb).float()
        if causal:
            mask = kv_pos[None, :] <= q_pos[:, None]
        else:
            mask = torch.ones((s, kv_chunk), dtype=torch.bool, device=dev)
        mask = mask & (kv_pos[None, :] < t)
        if window is not None:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        sc = torch.where(mask[None, None], sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))                       # [B,H,S]
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = einsum("bhst,bthd->bshd", p.to(vb.dtype), vb)
        acc = acc * corr.transpose(1, 2)[..., None].to(acc.dtype) + pv
        m = m_new
    denom = torch.clamp_min(l, 1e-20).transpose(1, 2)[..., None]
    return (acc.float() / denom).to(q.dtype)


def decode_attention(
    q: torch.Tensor,        # [B, 1, H, dh]
    k_cache: torch.Tensor,  # [B, T, Hkv, dh]
    v_cache: torch.Tensor,  # [B, T, Hkv, dv]
    cache_len: torch.Tensor,  # int32[B] valid prefix length
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-position attention against a (masked) KV cache, in grouped
    form (no KV repeat: the cache is the big object in decode)."""
    b, _, h, dh = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = scale if scale is not None else dh ** -0.5
    qs = q * scale
    if split_uneven(qs, 2, hkv):
        qs = gather_dim(qs, 2)     # the (hkv, g) split of sharded heads
    qg = qs.reshape(b, 1, hkv, g, dh)
    sc = einsum("bskgd,btkd->bkgst", qg, k_cache).float()
    mask = torch.arange(t, device=q.device)[None, :] < cache_len[:, None]
    sc = torch.where(mask[:, None, None, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = einsum("bkgst,btkd->bskgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, v_cache.shape[-1])


# ---------------------------------------------------------------------------
# GQA block (projections + rope + attention)
# ---------------------------------------------------------------------------
class GQA(nn.Module):
    def __init__(self, init: Init, cfg, dtype):
        super().__init__()
        d, h, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        dh = cfg.resolved_head_dim
        self.wq = Linear(init, d, (h, dh), bias=cfg.qkv_bias, dtype=dtype)
        self.wk = Linear(init, d, (hkv, dh), bias=cfg.qkv_bias, dtype=dtype)
        self.wv = Linear(init, d, (hkv, dh), bias=cfg.qkv_bias, dtype=dtype)
        self.wo = Linear(init, d, (h, dh), dtype=dtype)  # used transposed


def _proj_qkv(x, p, cfg, pos, mrope_pos):
    q, k, v = linear(x, p.wq), linear(x, p.wk), linear(x, p.wv)
    if cfg.mrope_sections and mrope_pos is not None:
        q = apply_mrope(q, mrope_pos, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, mrope_pos, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


def _out_proj(o, p):
    # o: [B,S,H,dh] x wo [d, H, dh] -> [B,S,d]
    w = p.wo.w
    if sharded_inside(w, 2):
        # the einsum merges (H, dh); sum the heads instead (layers.linear)
        return sum(torch.einsum("bsd,md->bsm", o[:, :, i], w[:, i])
                   for i in range(w.shape[1]))
    return einsum("bshd,mhd->bsm", o, w)


def gqa_forward(x, p, cfg, pos, *, mrope_pos=None):
    """Full-sequence (prefill) GQA.  pos: [B,S] absolute positions."""
    q, k, v = _proj_qkv(x, p, cfg, pos, mrope_pos)
    o = chunked_attention(q, k, v, causal=True, window=cfg.sliding_window,
                          kv_chunk=cfg.attn_chunk_kv)
    return _out_proj(o, p), (k, v)


def gqa_decode(x, p, cfg, cache_k, cache_v, cache_len, pos, *,
               mrope_pos=None):
    """One-token decode: write the cache (in place), attend.  x: [B,1,d].
    A sliding-window cache is a ring buffer of ``t`` slots."""
    q, k, v = _proj_qkv(x, p, cfg, pos, mrope_pos)
    t = cache_k.shape[1]
    write_idx = cache_len % t                                     # int32[B]
    cache_k = _cache_write(cache_k, k, write_idx)
    cache_v = _cache_write(cache_v, v, write_idx)
    new_len = torch.clamp_max(cache_len + 1, t)
    o = decode_attention(q, cache_k, cache_v, new_len)
    return _out_proj(o, p), (cache_k, cache_v, cache_len + 1)


def _cache_write(cache, val, idx):
    """cache [B,T,...] <- val [B,1,...] at per-batch position idx, in place
    (one slot per sequence); returns ``cache``."""
    if isinstance(cache, DTensor):
        return _cache_write_sharded(cache, val, idx)
    b = cache.shape[0]
    cache[torch.arange(b, device=cache.device), idx.long()] = val[:, 0]
    return cache


def _cache_write_sharded(cache, val, idx):
    """:func:`_cache_write` on a DTensor cache whose batch and sequence
    dims may be sharded (flash-decoding: each rank holds a T slab of its
    sequences).  Each rank writes, in its local shard, the slots that fall
    in its slab, and rewrites the slot it already holds elsewhere (the
    index clamped into the slab), so the write stays in place and touches
    B slots, as the plain write does."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    mesh, pl = cache.device_mesh, cache.placements
    batch_only = [p if p.is_shard(0) else Replicate() for p in pl]
    local = cache.to_local()
    v = val.redistribute(mesh, batch_only).to_local()[:, 0]
    i = idx.redistribute(mesh, batch_only).to_local().long()
    _, offset = compute_local_shape_and_global_offset(cache.shape, mesh, pl)
    i = i - offset[1]
    t = local.shape[1]
    inside = (i >= 0) & (i < t)
    i = i.clamp(0, t - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    keep = inside.reshape(-1, *([1] * (v.ndim - 1)))
    local[rows, i] = torch.where(keep, v.to(local.dtype), local[rows, i])
    return cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------
class MLA(nn.Module):
    def __init__(self, init: Init, cfg, dtype):
        super().__init__()
        d, h, m = cfg.d_model, cfg.num_heads, cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        self.wq = Linear(init, d, (h, qk), dtype=dtype)
        self.w_dkv = Linear(init, d, m.kv_lora_rank + m.qk_rope_head_dim,
                            dtype=dtype)
        self.w_uk = Linear(init, m.kv_lora_rank, (h, m.qk_nope_head_dim),
                           dtype=dtype)
        self.w_uv = Linear(init, m.kv_lora_rank, (h, m.v_head_dim),
                           dtype=dtype)
        self.wo = Linear(init, d, (h, m.v_head_dim), dtype=dtype)


def mla_forward(x, p, cfg, pos):
    """Full-sequence MLA: expand the latent, run standard attention."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    q = linear(x, p.wq)                                      # [B,S,H,qk]
    q_nope = q[..., : m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], pos, cfg.rope_theta)
    ckv = linear(x, p.w_dkv)                                 # [B,S,r+rope]
    c, k_rope = ckv[..., : m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    k_rope = apply_rope(k_rope[:, :, None, :], pos, cfg.rope_theta)
    k_nope = torch.einsum("bsr,rhd->bshd", c, p.w_uk.w)
    v = torch.einsum("bsr,rhd->bshd", c, p.w_uv.w)
    k = torch.cat(
        [k_nope, k_rope.expand(b, s, h, m.qk_rope_head_dim)], dim=-1)
    qq = torch.cat([q_nope, q_rope], dim=-1)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    o = chunked_attention(qq, k, v, causal=True, kv_chunk=cfg.attn_chunk_kv,
                          scale=scale)
    out = torch.einsum("bshd,mhd->bsm", o, p.wo.w)
    return out, (c, k_rope[:, :, 0, :])


def mla_decode(x, p, cfg, cache_c, cache_kr, cache_len, pos):
    """Absorbed-matmul MLA decode: the cache holds only (c_kv, k_rope),
    written in place.  x: [B,1,d]."""
    m = cfg.mla
    q = linear(x, p.wq)                                      # [B,1,H,qk]
    q_nope = q[..., : m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], pos, cfg.rope_theta)
    ckv = linear(x, p.w_dkv)
    c_new, kr_new = ckv[..., : m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    kr_new = apply_rope(kr_new[:, :, None, :], pos, cfg.rope_theta)[:, :, 0]

    t = cache_c.shape[1]
    idx = cache_len % t
    cache_c = _cache_write(cache_c, c_new, idx)
    cache_kr = _cache_write(cache_kr, kr_new, idx)
    new_len = torch.clamp_max(cache_len + 1, t)

    # absorb W_uk into the query:  score = (q_nope W_uk) . c  +  q_rope . k_rope
    q_abs = torch.einsum("bshd,rhd->bshr", q_nope, p.w_uk.w)  # [B,1,H,r]
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    sc = (torch.einsum("bshr,btr->bhst", q_abs, cache_c)
          + torch.einsum("bshd,btd->bhst", q_rope, cache_kr)).float() * scale
    mask = torch.arange(t, device=x.device)[None, :] < new_len[:, None]
    sc = torch.where(mask[:, None, None, :], sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1).to(cache_c.dtype)
    o_lat = torch.einsum("bhst,btr->bshr", pr, cache_c)      # [B,1,H,r]
    o = torch.einsum("bshr,rhd->bshd", o_lat, p.w_uv.w)
    out = torch.einsum("bshd,mhd->bsm", o, p.wo.w)
    return out, (cache_c, cache_kr, cache_len + 1)
