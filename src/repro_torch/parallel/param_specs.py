"""Parameter PartitionSpec rules: TP (+ optional FSDP) per tensor (port of
``repro.parallel.param_specs``).

Rules are path-driven over the parameters.  Two regimes:

* ``fsdp=False`` (models that fit TP-only): weights shard the obvious
  tensor-parallel axis (heads / d_ff / vocab / experts); everything else
  replicates.
* ``fsdp=True`` (the >=100 B configs): weights additionally shard their
  d_model-sized axis over the data axes -- 2-D (fsdp x tensor) sharding.

Optimizer states inherit the param spec; when a param is replicated on the
data axes, ``zero_spec`` additionally shards its largest divisible axis
over the data axes (ZeRO-1).

:func:`spec_for` and :func:`_spec_by_rules` are the reference's rules, on
the reference's leaf: its key path (``['blocks']/['attn']/['wq']/['w']``)
and its stacked shape, layers on the leading axes.  Several rules index
from the stacked rank (``wk``'s bias ``[L, Hkv, dh]`` takes ``[fs(nd-3),
None, tpx(nd-1)]``), so :func:`tree_specs` and :func:`opt_state_specs`
compute each of the port's per-layer leaves (``blocks.3.attn.wk.b``) at
its reference shape (``interop.lm_reference_shapes``) and drop the
leading stacked entries, which are ``None`` or name only mesh axes of
size 1 (the same layout).  A leaf whose stacked axes the reference
shards over a mesh axis of more ranks (a qkv bias's layer axis under
fsdp), in its parameter's spec or its moments' ZeRO spec, cannot be
split per layer: it is held stacked (``interop.STACKED``), one
``[L, ...]`` leaf with the reference's spec, and each layer takes its
slice at use (``sharding.stack_parameters``).
"""
from __future__ import annotations

from repro_torch import interop
from repro_torch.configs.base import ModelConfig

from .sharding import PartitionSpec as P
from .sharding import ShardingCtx


def _shardable(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def spec_for(path: str, shape: tuple[int, ...], cfg: ModelConfig,
             ctx: ShardingCtx, fsdp: bool) -> P:
    """PartitionSpec for one param leaf, identified by its tree path."""
    tp = ctx.rules.model_axis
    tpn = ctx.model_size
    dp = ctx.rules.dp                # 'data' or ('pod','data')
    dpn = ctx.data_size

    def fsdp_axis(dim: int):
        return dp if fsdp and _shardable(shape[dim], dpn) else None

    nd = len(shape)
    # strip scan-stacking prefix dims (layers/units): rules address the
    # trailing "semantic" dims; leading extras replicate.
    def pad(spec_tail: list) -> P:
        return P(*([None] * (nd - len(spec_tail)) + spec_tail))

    p = path.lower()

    # --- embeddings / heads -------------------------------------------------
    if "embed" in p and ("table" in p or "head" in p or "codebooks" in p or "heads" in p):
        # [V, d] (or [K, V, d])
        if _shardable(shape[-2], tpn):
            return pad([tp, fsdp_axis(nd - 1)])
        return pad([None, tp if _shardable(shape[-1], tpn) else None])

    return _spec_by_rules(p, shape, cfg, ctx, fsdp)


def _spec_by_rules(p: str, shape, cfg, ctx, fsdp: bool) -> P:
    tp = ctx.rules.model_axis
    tpn = ctx.model_size
    dp = ctx.rules.dp
    dpn = ctx.data_size
    nd = len(shape)

    def fs(dim: int):
        return dp if fsdp and _shardable(shape[dim], dpn) else None

    def pad(tail: list) -> P:
        return P(*([None] * (nd - len(tail)) + tail))

    def tpx(dim: int):
        return tp if _shardable(shape[dim], tpn) else None

    parts = p.replace("'", "").replace("[", "/").replace("]", "").split("/")
    parts = [q for q in parts if q]

    def has(*names):
        return any(n in parts for n in names)

    # --- mLSTM (megatron-style: up splits di, down contracts it; the
    # matrix memory shards its value dim dv) --------------------------------
    if "mlstm" in parts:
        if has("up_x", "up_g") and parts[-1] == "w":
            return pad([fs(nd - 2), tpx(nd - 1)])
        if has("wq", "wk", "wi", "wf", "down") and parts[-1] == "w":
            return pad([tpx(nd - 2), None])
        if has("wv") and parts[-1] == "w":
            return pad([None, tpx(nd - 1)])
        if has("gn"):
            return pad([None, tpx(nd - 1)])  # [H, dh]: shard dh (=dv)
        return P(*([None] * nd))
    if "slstm" in parts:        # tiny: replicate
        return P(*([None] * nd))

    # attention (flat heads; chunked_attention repeats KV per chunk):
    #   H % tp == 0  -> shard query heads; K/V replicate (repeat path
    #                   slices them to local heads for free)
    #   else         -> shard head_dim everywhere (consistent partial sums)
    h_tp = _shardable(cfg.num_heads, tpn)
    kv_tp = _shardable(cfg.num_kv_heads, tpn)
    if has("wq"):               # [d, H, dh]
        if h_tp:
            return pad([fs(nd - 3), tp, None])
        return pad([fs(nd - 3), None, tpx(nd - 1)])
    if has("wk", "wv"):         # [d, Hkv, dh]
        if kv_tp:
            return pad([fs(nd - 3), tp, None])
        # shard head_dim: K/V activations are small (gathered for
        # attention at ~16 MB/layer) while a model-replicated weight would
        # psum its 64 MB gradient over the model axis every microbatch
        # (§Perf llama3 iteration 3)
        return pad([fs(nd - 3), None, tpx(nd - 1)])
    if has("wo"):               # [d, H, dh] used transposed
        if h_tp:
            return pad([fs(nd - 3), tp, None])
        return pad([fs(nd - 3), None, tpx(nd - 1)])
    if has("w_uk", "w_uv"):     # MLA [r, H, d*]
        return pad([None, tpx(nd - 2), None])
    if has("w_dkv"):            # [d, r+rope] small latent proj
        return pad([fs(nd - 2), None])

    # mlp / moe
    if has("gate", "up", "up_x", "up_g", "ff_up") and parts[-1] in ("w", "b"):
        if parts[-1] == "b":
            return pad([tpx(nd - 1)])
        return pad([fs(nd - 2), tpx(nd - 1)])
    if has("down", "ff_down", "out_proj") and parts[-1] in ("w", "b"):
        if parts[-1] == "b":
            return pad([None])
        return pad([tpx(nd - 2), fs(nd - 1)])
    if has("w_gate", "w_up"):   # MoE bank [E, d, f]
        if _shardable(shape[-3], tpn):   # EP
            return pad([tp, fs(nd - 2), None])
        return pad([None, fs(nd - 2), tpx(nd - 1)])
    if has("w_down"):           # [E, f, d]
        if _shardable(shape[-3], tpn):
            return pad([tp, None, fs(nd - 1)])
        return pad([None, tpx(nd - 2), fs(nd - 1)])
    if has("router"):
        return pad([None] * min(nd, 2))

    # xlstm / ssm inner projections: [di, di] or [d, di]
    if has("wi", "wf") and parts[-1] == "w":
        return pad([tpx(nd - 2), None])   # [di, H] — H tiny, shard input dim
    if has("in_z", "in_x") and parts[-1] == "w":
        return pad([fs(nd - 2), tpx(nd - 1)])
    if has("in_bc", "in_dt"):
        return pad([None, None])
    if has("conv_x_w"):
        return pad([None, tpx(nd - 1)])
    if has("conv_x_b", "norm_g"):
        return pad([tpx(nd - 1)])
    if has("conv_bc_w", "conv_bc_b"):
        return pad([None] * min(nd, 2))
    if has("r"):                # sLSTM recurrent [4, H, dh, dh]
        return pad([None, tpx(nd - 3) if nd >= 3 else None, None, None][: nd])
    if has("gn"):               # [H, dh]
        return pad([tpx(nd - 2), None])

    # norms / scalars / everything else: replicated
    return P(*([None] * nd))


def _splits(entries, ctx: ShardingCtx) -> bool:
    """Whether any of the spec ``entries`` names a mesh axis of more than
    one rank."""
    sizes = ctx.shape
    return any(e is not None and any(
        sizes[a] > 1 for a in (e if isinstance(e, tuple) else (e,)))
        for e in entries)


def _unstacked(name: str, spec: P, depth: int, ctx: ShardingCtx) -> P:
    """``spec`` without its ``depth`` leading layer entries, which must
    be replicated: ``None``, or mesh axes of size 1 only (the same
    layout)."""
    if _splits(spec[:depth], ctx):
        raise ValueError(f"{name}: the reference shards a stacked layer "
                         f"axis ({spec!r}); a per-layer leaf cannot be")
    return P(*spec[depth:])


def tree_specs(params, cfg: ModelConfig, ctx: ShardingCtx,
               fsdp: bool = False) -> dict[str, P]:
    """PartitionSpec of each parameter, by name: ``params`` maps the
    model's parameter names to tensors (``meta`` ones do) or shapes.  A
    leaf the reference shards across its stacked layer axes (module
    docstring) is one stacked name with the reference's spec, in place
    of its per-layer names."""
    ref = interop.lm_reference_shapes(params)
    out = {}
    for name, (_, shape) in ref.items():
        path, idx = interop.lm_split_name(name)
        spec = spec_for(interop.lm_reference_key(path), shape, cfg, ctx,
                        fsdp)
        depth = len(idx)
        if _splits(spec[:depth], ctx) or _splits(
                zero_spec(spec, shape, ctx)[:depth], ctx):
            out.setdefault(interop.lm_stacked_name(path), spec)
        else:
            out[name] = _unstacked(name, spec, depth, ctx)
    return out


def zero_spec(spec: P, shape: tuple[int, ...], ctx: ShardingCtx) -> P:
    """Add ZeRO sharding: put the data axes on the largest still-replicated
    divisible dim of an optimizer-state leaf."""
    dpn = ctx.data_size
    dp = ctx.rules.dp
    used = set()
    for s in spec:
        if s is None:
            continue
        for a in (s if isinstance(s, tuple) else (s,)):
            used.add(a)
    for a in (dp if isinstance(dp, tuple) else (dp,)):
        if a in used:
            return spec  # params already fsdp-sharded
    best, best_dim = 0, -1
    for i, (s, n) in enumerate(zip(spec, shape)):
        if s is None and n % dpn == 0 and n > best:
            best, best_dim = n, i
    if best_dim < 0:
        return spec
    new = list(spec)
    new[best_dim] = dp
    return P(*new)


def opt_state_specs(param_specs: dict, params, ctx: ShardingCtx):
    """Specs for AdamW (step, mu, nu): mu/nu = param spec + ZeRO, each
    taken at the leaf's reference (stacked) shape.  ``params`` may hold
    the per-layer leaves of a stacked name of ``param_specs``."""
    from repro_torch.training.optimizer import AdamWState

    shapes = {interop.lm_split_name(k)[0]: shape
              for k, (_, shape) in interop.lm_reference_shapes(
                  params).items()}
    z = {}
    for name, spec in param_specs.items():
        shape = shapes[interop.lm_split_name(name)[0]]
        depth = len(shape) - len(spec)
        stacked = zero_spec(P(*([None] * depth), *spec), shape, ctx)
        z[name] = _unstacked(name, stacked, depth, ctx)
    return AdamWState(step=P(), mu=z, nu=dict(z))
