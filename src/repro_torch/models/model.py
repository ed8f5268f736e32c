"""Model facade: init / forward (prefill) / decode for every family (port
of ``repro.models.model``).

``build_model(cfg)`` returns a :class:`Model`, an ``nn.Module`` whose
submodules carry the reference's parameter names, one module per layer
(``blocks.3.attn.wq.w`` is layer 3's slice of the reference's stacked
``params["blocks"]["attn"]["wq"]["w"]``).  A decode state is a dict like
the reference's, with one entry per layer where the reference stacks a
leading layer axis (``interop.lm_state_from_reference`` converts); the
KV caches in it are written in place by :func:`decode_step`.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import resolve_device
from repro_torch.parallel.sharding import with_sharding

from . import attention as attn_mod
from . import embedding as emb
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .layers import MLP, Init, RMSNorm, dtype_of, mlp, rmsnorm
from .transformer import AttnMLPBlock, attn_mlp_decode, attn_mlp_forward


class Codebooks(nn.Module):
    """musicgen: K codebook embeddings and K heads, ``[K, V, d]`` each."""

    def __init__(self, init: Init, cfg, dtype):
        super().__init__()
        shape = (cfg.num_codebooks, cfg.vocab_size, cfg.d_model)
        self.codebooks = init.normal(shape, cfg.d_model ** -0.5, dtype)
        self.heads = init.normal(shape, 0.02, dtype)


def _layers(make, n):
    return nn.ModuleList(make() for _ in range(n))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
class Model(nn.Module):
    """The parameters of ``cfg``'s model, drawn by ``init``, with the
    forward pass and the decode step as methods."""

    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        self.cfg = cfg
        dt = dtype_of(cfg.dtype)
        self.final_norm = RMSNorm(init, cfg.d_model, dt)
        if cfg.num_codebooks:
            self.embed = Codebooks(init, cfg, dt)
        else:
            self.embed = emb.Embedding(init, cfg.vocab_size, cfg.d_model,
                                       dt, tie=cfg.tie_embeddings)

        fam = cfg.family
        block = lambda use_moe: lambda: AttnMLPBlock(init, cfg, dt, use_moe)
        if fam in ("dense", "audio", "vlm"):
            self.blocks = _layers(block(False), cfg.num_layers)
        elif fam == "moe":
            fd = cfg.moe.first_dense_layers
            if fd:
                self.dense_blocks = _layers(block(False), fd)
            self.blocks = _layers(block(True), cfg.num_layers - fd)
        elif fam == "ssm":  # xlstm
            k = cfg.xlstm.slstm_every
            units = cfg.num_layers // k
            self.mlstm = _layers(lambda: _layers(
                lambda: xlstm_mod.MLSTMBlock(init, cfg, dt), k - 1), units)
            self.slstm = _layers(
                lambda: xlstm_mod.SLSTMBlock(init, cfg, dt), units)
        elif fam == "hybrid":  # zamba2
            k = cfg.attn_every
            lead, units = cfg.num_layers % k, cfg.num_layers // k
            mamba = lambda: ssm_mod.Mamba2(init, cfg, dt)
            if lead:
                self.mamba_lead = _layers(mamba, lead)
            self.mamba = _layers(lambda: _layers(mamba, k), units)
            self.shared_attn = attn_mod.GQA(init, cfg, dt)
            self.shared_ln = RMSNorm(init, cfg.d_model, dt)
            if cfg.d_ff:
                self.shared_mlp = MLP(init, cfg.d_model, cfg.d_ff, dt)
                self.shared_ln2 = RMSNorm(init, cfg.d_model, dt)
        else:
            raise ValueError(f"unknown family {fam!r}")

    @property
    def device(self) -> torch.device:
        return self.final_norm.g.device

    def forward(self, batch, ctx=None):
        """Full-sequence forward: ``(logits, aux_loss)``."""
        return forward(self, batch, self.cfg, ctx)

    def init_decode_state(self, batch: int, cache_len: int, dtype=None):
        return init_decode_state(self.cfg, batch, cache_len, dtype,
                                 device=self.device)

    def decode_step(self, state, batch, ctx=None):
        """One-token decode: ``(logits, new_state)``."""
        return decode_step(self, state, batch, self.cfg, ctx)


def build_model(cfg: ModelConfig, device=None, seed: int = 0) -> Model:
    """``cfg``'s model with weights drawn from a ``torch.Generator`` seeded
    ``seed`` on ``device`` (the CUDA card unless ``"cpu"`` is given; on
    ``"meta"`` the weights are shapes only, as for the dry run)."""
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    return Model(cfg, Init(gen, dev))


# ---------------------------------------------------------------------------
# input embedding per family
# ---------------------------------------------------------------------------
def _embed_inputs(model, batch, cfg, ctx):
    if cfg.num_codebooks:
        if "frame_embeds" in batch:        # audio stub frontend
            return batch["frame_embeds"], None
        codes = batch["codes"]             # [B, S, K]: sum the codebooks
        books = model.embed.codebooks
        x = torch.stack([books[k][codes[..., k]]
                         for k in range(cfg.num_codebooks)], dim=2)
        return x.sum(dim=2), None
    x = emb.embed(batch["tokens"], model.embed, ctx)
    if cfg.frontend == "vision_stub" and "vision_embeds" in batch:
        x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
    return x, batch.get("mrope_pos")


def _head(model, x, cfg, ctx):
    if cfg.num_codebooks:
        return torch.einsum("bsd,kvd->bskv", x, model.embed.heads)
    return emb.logits(x, model.embed, ctx, tie=cfg.tie_embeddings)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------
def _scan(body, x, aux, units, remat: bool):
    """Loop ``body(x, aux, unit) -> (x, aux)`` over ``units``; with
    ``remat`` each call is checkpointed (its activations are recomputed in
    the backward pass), as the reference's ``scan_layers`` wraps the scan
    body in ``jax.checkpoint(..., nothing_saveable)``."""
    for unit in units:
        if remat:
            x, aux = checkpoint(body, x, aux, unit, use_reentrant=False)
        else:
            x, aux = body(x, aux, unit)
    return x, aux


def forward(model, batch, cfg: ModelConfig, ctx=None):
    """Full-sequence forward.  Returns (logits, aux_loss).

    With ``cfg.remat`` and grad enabled, the body of each reference scan
    step is rematerialised: one block (dense, moe, audio, vlm), one xLSTM
    unit (k-1 mLSTM + 1 sLSTM), one zamba2 unit (k Mamba2 blocks and the
    shared attention/MLP), one lead Mamba2 block.

    With ``ctx`` (a ``parallel.ShardingCtx`` over a ``DeviceMesh``; the
    parameters and the batch DTensors) the activations are redistributed
    at the reference's ``with_sharding`` sites; the caller runs it under
    ``implicit_replication()`` (the train step and the dry run do), so
    that the positions and masks built here count as replicated."""
    x, mrope_pos = _embed_inputs(model, batch, cfg, ctx)
    b, s, _ = x.shape
    pos = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(
        b, s)
    x = with_sharding(ctx, x, "batch", None, None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    fam = cfg.family
    remat = cfg.remat and torch.is_grad_enabled()

    def residual(h, y):
        # the residual sum in the layer boundary's layout, as
        # transformer.attn_mlp_forward's: left free, DTensor reduce-
        # scatters a block's partial sum onto the sequence dim, which the
        # recurrences then cut into chunks or steps
        return with_sharding(ctx, h + y, "batch", "seq", None)

    if fam in ("dense", "audio", "vlm", "moe"):
        def make_body(use_moe):
            def body(h, a, blk):
                # inter-layer residual: sequence-parallel when enabled
                h = with_sharding(ctx, h, "batch", "seq", None)
                h, _kv, aux_l = attn_mlp_forward(
                    h, blk, cfg, pos, use_moe, mrope_pos=mrope_pos, ctx=ctx)
                return h, a + aux_l
            return body
        stacks = [(model.blocks, fam == "moe")]
        if fam == "moe" and cfg.moe.first_dense_layers:
            stacks.insert(0, (model.dense_blocks, False))
        for blocks, use_moe in stacks:
            x, aux = _scan(make_body(use_moe), x, aux, blocks, remat)

    elif fam == "ssm":  # xlstm units
        def body(h, a, unit):
            mblocks, sblock = unit
            for blk in mblocks:
                h = residual(h, xlstm_mod.mlstm_forward(h, blk, cfg)[0])
            return residual(h, xlstm_mod.slstm_forward(h, sblock, cfg)[0]), a
        x, aux = _scan(body, x, aux, zip(model.mlstm, model.slstm), remat)

    elif fam == "hybrid":  # zamba2 units, shared attention block
        def lead_body(h, a, blk):
            return residual(h, ssm_mod.mamba2_forward(h, blk, cfg)[0]), a

        def body(h, a, mblocks):
            for i, blk in enumerate(mblocks):
                if i == len(mblocks) - 1:  # shared full-attention (+MLP)
                    h = residual(h, attn_mod.gqa_forward(
                        rmsnorm(h, model.shared_ln, cfg.norm_eps),
                        model.shared_attn, cfg, pos)[0])
                    if hasattr(model, "shared_mlp"):
                        h = residual(h, mlp(rmsnorm(
                            h, model.shared_ln2, cfg.norm_eps),
                            model.shared_mlp))
                h = residual(h, ssm_mod.mamba2_forward(h, blk, cfg)[0])
            return h, a
        x, aux = _scan(lead_body, x, aux, getattr(model, "mamba_lead", ()),
                       remat)
        x, aux = _scan(body, x, aux, model.mamba, remat)
    else:
        raise ValueError(fam)

    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    return _head(model, x, cfg, ctx), aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      dtype=None, device=None) -> dict[str, Any]:
    """Fresh decode state sized for ``cache_len`` past tokens: the
    reference's entries, with a list over layers (over units, and over
    the blocks of a unit) in place of each stacked leading axis."""
    dev = resolve_device(device)
    dt = dtype or dtype_of(cfg.dtype)
    fam = cfg.family
    hd = cfg.resolved_head_dim
    zeros = lambda *shape, dtype=dt: torch.zeros(shape, dtype=dtype,
                                                 device=dev)
    state: dict[str, Any] = {"pos": zeros(batch, dtype=torch.int32),
                             "len": zeros(batch, dtype=torch.int32)}
    t = (cache_len if not cfg.sliding_window
         else min(cache_len, cfg.sliding_window))
    if fam in ("dense", "audio", "vlm", "moe"):
        fd = cfg.moe.first_dense_layers if cfg.moe else 0

        def mk_kv(layers):
            if cfg.attn_type == "mla":
                m = cfg.mla
                return [(zeros(batch, t, m.kv_lora_rank),
                         zeros(batch, t, m.qk_rope_head_dim))
                        for _ in range(layers)]
            return [(zeros(batch, t, cfg.num_kv_heads, hd),
                     zeros(batch, t, cfg.num_kv_heads, hd))
                    for _ in range(layers)]
        if fd:
            state["dense_cache"] = mk_kv(fd)
        state["cache"] = mk_kv(cfg.num_layers - fd)
    elif fam == "ssm":
        k = cfg.xlstm.slstm_every
        units = cfg.num_layers // k
        _, heads, dh = xlstm_mod.mlstm_dims(cfg)
        state["mlstm"] = [[xlstm_mod.mlstm_state0(batch, heads, dh, dev)
                           for _ in range(k - 1)] for _ in range(units)]
        state["slstm"] = [xlstm_mod.slstm_state0(
            batch, cfg.num_heads, cfg.d_model // cfg.num_heads, dev)
            for _ in range(units)]
    elif fam == "hybrid":
        k = cfg.attn_every
        units, lead = cfg.num_layers // k, cfg.num_layers % k
        d_inner, heads, dh, n_ssm = ssm_mod.ssm_dims(cfg)
        cw = cfg.ssm.conv_width

        def mk_ssm():
            return ssm_mod.SSMState(
                h=zeros(batch, heads, dh, n_ssm, dtype=torch.float32),
                conv_x=zeros(batch, cw - 1, d_inner),
                conv_bc=zeros(batch, cw - 1, 2 * n_ssm))
        if lead:
            state["lead"] = [mk_ssm() for _ in range(lead)]
        state["mamba"] = [[mk_ssm() for _ in range(k)]
                          for _ in range(units)]
        state["attn_cache"] = [(zeros(batch, t, cfg.num_kv_heads, hd),
                                zeros(batch, t, cfg.num_kv_heads, hd))
                               for _ in range(units)]
    return state


def decode_step(model, state, batch, cfg: ModelConfig, ctx=None):
    """One-token decode.  batch: {"tokens": [B,1]} (or codes for audio).
    Returns (logits, new_state); the KV caches are written in place and
    shared by both states.  ``ctx`` as for :func:`forward`."""
    x, mrope_pos = _embed_inputs(model, batch, cfg, ctx)
    pos = state["pos"][:, None]
    cache_len = state["len"]
    new_state = dict(state)
    fam = cfg.family

    if fam in ("dense", "audio", "vlm", "moe"):
        use_moe = fam == "moe"
        stacks = [("cache", model.blocks, use_moe)]
        if use_moe and cfg.moe.first_dense_layers:
            stacks.insert(0, ("dense_cache", model.dense_blocks, False))
        for key, blocks, u_moe in stacks:
            caches = []
            for blk, cache in zip(blocks, state[key], strict=True):
                x, cache = attn_mlp_decode(x, blk, cfg, cache, cache_len,
                                           pos, u_moe, mrope_pos=mrope_pos)
                caches.append(cache)
            new_state[key] = caches

    elif fam == "ssm":
        new_m, new_s = [], []
        for mblocks, sblock, mstates, sstate in zip(
                model.mlstm, model.slstm, state["mlstm"], state["slstm"],
                strict=True):
            unit = []
            for blk, st in zip(mblocks, mstates, strict=True):
                y, st = xlstm_mod.mlstm_decode(x, blk, cfg, st)
                x = x + y
                unit.append(st)
            y, sstate = xlstm_mod.slstm_forward(x, sblock, cfg, sstate)
            x = x + y
            new_m.append(unit)
            new_s.append(sstate)
        new_state["mlstm"], new_state["slstm"] = new_m, new_s

    elif fam == "hybrid":
        if "lead" in state:
            lead = []
            for blk, st in zip(model.mamba_lead, state["lead"], strict=True):
                y, st = ssm_mod.mamba2_decode(x, blk, cfg, st)
                x = x + y
                lead.append(st)
            new_state["lead"] = lead
        new_m, new_c = [], []
        for mblocks, mstates, (ck, cv) in zip(
                model.mamba, state["mamba"], state["attn_cache"],
                strict=True):
            unit = []
            for i, (blk, st) in enumerate(zip(mblocks, mstates,
                                              strict=True)):
                if i == len(mblocks) - 1:
                    a, (ck, cv, _) = attn_mod.gqa_decode(
                        rmsnorm(x, model.shared_ln, cfg.norm_eps),
                        model.shared_attn, cfg, ck, cv, cache_len, pos)
                    x = x + a
                    if hasattr(model, "shared_mlp"):
                        x = x + mlp(rmsnorm(x, model.shared_ln2,
                                            cfg.norm_eps), model.shared_mlp)
                y, st = ssm_mod.mamba2_decode(x, blk, cfg, st)
                x = x + y
                unit.append(st)
            new_m.append(unit)
            new_c.append((ck, cv))
        new_state["mamba"], new_state["attn_cache"] = new_m, new_c
    else:
        raise ValueError(fam)

    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    lg = _head(model, x, cfg, ctx)
    new_state["pos"] = state["pos"] + 1
    new_state["len"] = state["len"] + 1
    return lg, new_state
