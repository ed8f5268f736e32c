"""Common layers: RMSNorm, SwiGLU MLP, linear init, RoPE and M-RoPE
(port of ``repro.models.layers``).

Weights keep the reference's layouts (a linear's ``w`` is ``[d_in,
*d_out]``), so a reference parameter tree loads leaf for leaf
(``interop.lm_params_from_reference``).  :class:`Init` draws them from one
``torch.Generator`` with the reference's distributions (normal x scale in
float32, cast to the weight's dtype); it does not reproduce ``jax.random``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# init / linear
# ---------------------------------------------------------------------------
class Init:
    """Draws weights on ``device`` from ``generator`` (which may live on
    another device: the draws move).  Every weight is an ``nn.Parameter``
    created frozen, so serving builds no autograd graph; the trainer
    (``training.train_step``) makes them trainable with
    ``model.requires_grad_(True)``.  On the ``meta`` device nothing is
    drawn (``generator`` may be None): the weights are shapes only."""

    def __init__(self, generator: torch.Generator, device):
        self.gen, self.device = generator, torch.device(device)

    def _param(self, t: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(t, requires_grad=False)

    def normal(self, shape, scale: float, dtype) -> nn.Parameter:
        if self.device.type == "meta":
            return self._param(torch.empty(tuple(shape), dtype=dtype,
                                           device=self.device))
        t = torch.randn(tuple(shape), generator=self.gen,
                        dtype=torch.float32, device=self.gen.device) * scale
        return self._param(t.to(device=self.device, dtype=dtype))

    def full(self, shape, value: float, dtype) -> nn.Parameter:
        return self._param(torch.full(tuple(shape), value, dtype=dtype,
                                      device=self.device))

    def tensor(self, t: torch.Tensor) -> nn.Parameter:
        return self._param(t.to(self.device))


class Linear(nn.Module):
    """``w [d_in, *d_out]`` (normal x ``scale``) and an optional zero
    bias ``b [*d_out]``."""

    def __init__(self, init: Init, d_in: int, d_out, bias: bool = False,
                 scale: float = 0.02, dtype=torch.bfloat16):
        super().__init__()
        shape = (d_in,) + (d_out if isinstance(d_out, tuple) else (d_out,))
        self.w = init.normal(shape, scale, dtype)
        if bias:
            self.b = init.full(shape[1:], 0.0, dtype)

    def forward(self, x):
        return linear(x, self)


def linear(x: torch.Tensor, p) -> torch.Tensor:
    """Contract ``x``'s last dim with ``p.w``'s first; the result has
    ``x``'s dtype (the reference's ``preferred_element_type``), computed in
    the promoted dtype of the two operands."""
    w = p.w
    ct = torch.promote_types(x.dtype, w.dtype)
    x2 = x.to(ct).reshape(-1, w.shape[0])
    if sharded_inside(w, 2):
        # a DTensor weight [d_in, H, k] sharded on k: merging (H, k) into
        # one dim is a view DTensor refuses (torch 2.11), so one matmul
        # per leading output index
        y = torch.stack([x2 @ w[:, i].to(ct) for i in range(w.shape[1])], 1)
    else:
        y = x2 @ w.to(ct).reshape(w.shape[0], -1)
    y = y.to(x.dtype).reshape(*x.shape[:-1], *w.shape[1:])
    b = getattr(p, "b", None)
    return y if b is None else y + b


def sharded_inside(w: torch.Tensor, first: int) -> bool:
    """Whether ``w`` is a DTensor sharded on a dim at or past ``first``
    (a dim that a flattening view would merge into the one before it)."""
    from torch.distributed.tensor import DTensor

    return isinstance(w, DTensor) and any(
        p.is_shard() and p.dim >= first for p in w.placements)


def split_uneven(x: torch.Tensor, dim: int, outer: int) -> bool:
    """Whether ``x`` is a DTensor sharding ``dim`` over a mesh dim whose
    size does not divide ``outer``: splitting ``dim`` into ``(outer,
    dim // outer)`` is then a view DTensor refuses."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor) and any(
        p.is_shard(dim) and outer % x.device_mesh.size(i)
        for i, p in enumerate(x.placements))


def einsum(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, *xs)``; on DTensors, per rank on local shards.

    Each mesh dim keeps the index that the first operand sharded on it
    shards, when it splits that index evenly after the mesh dims before
    it: every operand holding that index is resharded to it (a local
    slice where it was replicated) and the others replicated, so the
    contraction runs per rank and the result is sharded on that index,
    or a partial sum where ``eq`` contracts it.  A partial operand is
    reduced first, and a mesh dim that shards no index, or not evenly,
    is replicated.  DTensor's own
    einsum flattens the batch indices for ``bmm``, which torch 2.11
    refuses when a second one is sharded (attention's batch and heads,
    the SSD scan's batch and heads)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not xs or not all(isinstance(x, DTensor) for x in xs):
        return torch.einsum(eq, *xs)
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    mesh = xs[0].device_mesh
    # each index's extent left to split by the mesh dims after this one
    left = {c: n for spec, x in zip(ins, xs) for c, n in zip(spec, x.shape)}
    target = [[Replicate()] * mesh.ndim for _ in xs]
    out_pl, keeps = [], []
    for i, n in enumerate(mesh.shape):
        keep = next((spec[x.placements[i].dim] for spec, x in zip(ins, xs)
                     if x.placements[i].is_shard()), None)
        if keep is not None and left[keep] % n:
            keep = None
        if keep is not None:
            left[keep] //= n
        keeps.append(keep)
        for j, spec in enumerate(ins):
            if keep is not None and keep in spec:
                target[j][i] = Shard(spec.index(keep))
        out_pl.append(Replicate() if keep is None else
                      Shard(out.index(keep)) if keep in out else Partial())
    xs = [x if list(x.placements) == t else x.redistribute(mesh, t)
          for x, t in zip(xs, target)]
    # an operand replicated over a mesh dim that splits the contraction
    # gets a partial sum of its gradient on each rank
    grads = [[Partial() if t[i].is_replicate() and p is not None else t[i]
              for i, p in enumerate(keeps)] for t in target]
    local = torch.einsum(eq, *(x.to_local(grad_placements=g)
                              for x, g in zip(xs, grads)))
    return DTensor.from_local(local, mesh, out_pl, run_check=False)


def gather_dim(x, dim: int):
    """The DTensor ``x`` with ``dim`` whole: every mesh dim that shards
    it replicated (an all-gather)."""
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_shard(dim) else p for p in x.placements])


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
class RMSNorm(nn.Module):
    def __init__(self, init: Init, d: int, dtype=torch.bfloat16):
        super().__init__()
        self.g = init.full((d,), 1.0, dtype)


def rmsnorm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * p.g


class GroupNorm(nn.Module):
    def __init__(self, init: Init, heads: int, d: int, dtype=torch.bfloat16):
        super().__init__()
        self.g = init.full((heads, d), 1.0, dtype)


def groupnorm_heads(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """Per-head RMS norm over the head dim: x [..., H, dh]."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * p.g


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, init: Init, d: int, d_ff: int, dtype=torch.bfloat16):
        super().__init__()
        self.gate = Linear(init, d, d_ff, dtype=dtype)
        self.up = Linear(init, d, d_ff, dtype=dtype)
        self.down = Linear(init, d_ff, d, dtype=dtype)

    def forward(self, x):
        return mlp(x, self)


def mlp(x: torch.Tensor, p) -> torch.Tensor:
    return linear(F.silu(linear(x, p.gate)) * linear(x, p.up), p.down)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta ** (2i / dh)`` in float32, in the reference's order: the
    power, then its reciprocal (no scalar is divided by a tensor, which
    torch would round twice).  The power is taken in float64 and rounded
    once.  Neither float32 ``pow`` is correctly rounded, so bit equality
    with XLA's cannot be had: over dh 2..298 and six thetas this differs
    from it in 72 of 67,050 slots (torch's float32 ``pow`` in 834), each
    by one ulp."""
    ex = torch.arange(0, head_dim, 2, dtype=torch.float32,
                      device=device) / head_dim
    th = torch.tensor(theta, dtype=torch.float64, device=device)
    return torch.reciprocal(torch.pow(th, ex.double()).float())


def _rotate(x, ang):
    dh = x.shape[-1]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float):
    """x: [B, S, H, dh]; pos: [B, S] (int) -> rotated x (pairwise halves)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # [dh/2]
    return _rotate(x, pos[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor,
                sections: tuple[int, ...], theta: float) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    x: [B, S, H, dh]; pos3: [3, B, S] (temporal, height, width positions).
    ``sections`` split dh/2 frequency slots among the three position kinds.
    """
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)
    # pick which position stream drives each frequency slot
    sec = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                     for i, s in enumerate(sections)])[: dh // 2]
    pos_sel = pos3.permute(1, 2, 0).float()[..., sec]            # [B,S,dh/2]
    return _rotate(x, pos_sel * freqs)
