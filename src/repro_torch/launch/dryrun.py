"""Production dry run: trace every (architecture x input shape) on the
production mesh over a ``fake`` process group, prove it fits (the
per-device bytes of the arguments) and extract roofline inputs (op-trace
FLOPs, bytes and the collectives DTensor inserts) -- the port of
``repro.launch.dryrun``.

Nothing compiles and nothing runs on a device: :func:`lower_cell` starts
a ``fake`` process group of 256 (or 512) ranks in this one process
(:func:`fake_world`, always destroyed on the way out), builds the model on
``meta`` at full width, turns the parameters, the AdamW states, the batch
and the decode state into DTensors in the layouts of
``parallel.param_specs`` and of the rules below, and runs the train step
(or the prefill, or one decode step) under ``hlo_analysis.OpTrace`` and
``CommDebugMode``.  Every count is per device: DTensor runs each op on the
rank's local shard.  An op that DTensor cannot propagate ends the cell as
``status: "error"`` with its message (the reference's error path).

The reference sets ``XLA_FLAGS`` when it is imported; importing this
module starts nothing.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \
        --shape train_4k,decode_32k --mesh single --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.distributed.tensor.experimental import (
    implicit_replication as _replicated)

from repro_torch import interop
from repro_torch.configs import ARCHS, LONG_CONTEXT_OK, SHAPES, get_arch
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models import model as model_mod
from repro_torch.parallel import param_specs as pspec
from repro_torch.parallel.sharding import (
    PartitionSpec as P, distribute, distribute_parameters, make_ctx,
    placements)
from repro_torch.training.optimizer import AdamWConfig, AdamWState, adamw_init
from repro_torch.training.train_step import TrainConfig, make_train_step

# ---------------------------------------------------------------------------
# per-cell memory/distribution knobs (the >=100B archs need FSDP + lean
# optimizer states + bf16 grad accumulation to fit a 256-device pod)
# ---------------------------------------------------------------------------
BIG = {"llama3-405b", "mistral-large-123b"}
MID = {"mixtral-8x7b"}


def cell_knobs(arch: str, shape: ShapeConfig) -> dict:
    k = dict(fsdp=False, microbatches=1, accum_dtype="float32",
             opt_dtype="float32", sequence_parallel=False)
    if shape.kind == "train":
        if arch in BIG:
            k.update(fsdp=True, microbatches=16, accum_dtype="bfloat16",
                     opt_dtype="bfloat16")
        elif arch in MID:
            k.update(fsdp=True, microbatches=8, accum_dtype="bfloat16",
                     opt_dtype="bfloat16")
        elif arch == "deepseek-v2-lite-16b":
            k.update(microbatches=8)
        else:
            k.update(microbatches=4)
    # >=100B params never fit TP-only: 2-D (data x model) weight sharding
    # for serving too
    elif arch in BIG:
        k.update(fsdp=True)
    return k


# ---------------------------------------------------------------------------
# input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------
def _sd(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Abstract model inputs for one cell (the reference's dtypes)."""
    b = shape.global_batch
    s = shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind in ("train", "prefill"):
        if cfg.num_codebooks:
            d = {"frame_embeds": _sd((b, s, cfg.d_model), bf16)}
            if shape.kind == "train":
                d["labels"] = _sd((b, s, cfg.num_codebooks), i32)
            return d
        d = {}
        if cfg.frontend == "vision_stub":
            tv = cfg.vision_tokens
            d["tokens"] = _sd((b, s - tv), i32)
            d["vision_embeds"] = _sd((b, tv, cfg.d_model), bf16)
            d["mrope_pos"] = _sd((3, b, s), i32)
        else:
            d["tokens"] = _sd((b, s), i32)
        if shape.kind == "train":
            d["labels"] = _sd((b, s), i32)
        return d
    # decode: one new token against a seq_len-deep cache
    if cfg.num_codebooks:
        return {"codes": _sd((b, 1, cfg.num_codebooks), i32)}
    d = {"tokens": _sd((b, 1), i32)}
    if cfg.frontend == "vision_stub":
        d["mrope_pos"] = _sd((3, b, 1), i32)
    return d


def batch_shardings(batch, cfg, ctx) -> dict:
    """Spec of each batch leaf: its batch dim over the data axes where
    divisible."""
    dp = ctx.rules.dp
    dpn = ctx.data_size

    def spec(k, v):
        bdim = v.shape[1] if k == "mrope_pos" else v.shape[0]
        lead = dp if bdim % dpn == 0 else None
        if k == "mrope_pos":
            return P(None, lead, *([None] * (v.ndim - 2)))
        return P(lead, *([None] * (v.ndim - 1)))

    return {k: spec(k, v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# decode-state shardings (path-driven, on the reference's stacked leaves)
# ---------------------------------------------------------------------------
def _leaf_spec(path: str, shape, ctx) -> P:
    """The reference's ``decode_state_specs`` rule for one leaf, given its
    key path (``['cache']/[0]``, ``['mlstm']/.c``) and stacked shape."""
    tp = ctx.rules.model_axis
    tpn = ctx.model_size
    dp = ctx.rules.dp
    dpn = ctx.data_size

    def div(n, m):
        return n % m == 0

    nd = len(shape)
    parts = [q for q in path.replace("'", "").replace("[", "/")
             .replace("]", "").split("/") if q]

    def batch_ax(i):
        return dp if div(shape[i], dpn) else None

    if parts[-1] in ("pos", "len"):
        return P(batch_ax(0))
    if "cache" in parts[0] or parts[0] in ("attn_cache", "dense_cache"):
        # The cache's sequence axis is tensor-parallel (flash-decoding):
        # every device holds a T/tp slab of every sequence.
        # GQA kv: [L,B,T,H,dh] | MLA c: [L,B,T,r] / kr: [L,B,T,rope]
        t_ax = tp if div(shape[2], tpn) else None
        if nd == 5:
            return P(None, batch_ax(1), t_ax, None, None)
        if nd == 4:
            return P(None, batch_ax(1), t_ax, None)
    if parts[0] == "mlstm":
        # c [U,k,B,H,dk,dv] / n [U,k,B,H,dk] / m [U,k,B,H]
        if parts[-1] == "c":
            return P(None, None, batch_ax(2), None, None,
                     tp if div(shape[5], tpn) else None)
        if parts[-1] == "n":
            return P(None, None, batch_ax(2), None, None)
        return P(None, None, batch_ax(2), None)
    if parts[0] == "slstm":
        return P(None, batch_ax(1), *([None] * (nd - 2)))
    if parts[0] in ("mamba", "lead"):
        pre = 2 if parts[0] == "mamba" else 1
        if parts[-1] == "h":      # [.., B, H, dh, N]
            return P(*([None] * pre), batch_ax(pre),
                     tp if div(shape[pre + 1], tpn) else None, None, None)
        if parts[-1] == "conv_x":  # [.., B, w-1, di]
            return P(*([None] * pre), batch_ax(pre), None,
                     tp if div(shape[pre + 2], tpn) else None)
        return P(*([None] * pre), batch_ax(pre), *([None] * (nd - pre - 1)))
    return P(*([None] * nd))


def _state_leaves(node, path: str, depth: int, counts=()):
    """``(path, stacked counts, leaf, index key)`` over one entry of the
    port's decode state: ``depth`` list levels (the reference's stacked
    axes), then tuples (``[i]``) and NamedTuples (``.f``)."""
    if depth:
        for i, item in enumerate(node):
            yield from ((p, c, leaf, (i, *key)) for p, c, leaf, key in
                        _state_leaves(item, path, depth - 1,
                                      (*counts, len(node))))
        return
    if isinstance(node, tuple):
        names = (node._fields if hasattr(node, "_fields")
                 else range(len(node)))
        for i, name in enumerate(names):
            sub = f".{name}" if isinstance(name, str) else f"[{name}]"
            yield from ((p, c, leaf, (i, *key)) for p, c, leaf, key in
                        _state_leaves(node[i], f"{path}/{sub}", 0, counts))
        return
    yield path, counts, node, ()


def _rebuild(node, depth, values):
    """``node``'s structure with leaves from ``values`` (keyed by index
    path, as :func:`_state_leaves` gives)."""
    def go(n, d, key):
        if d or isinstance(n, tuple):
            items = [go(x, max(d - 1, 0), (*key, i)) for i, x in enumerate(n)]
            if d:
                return items
            return type(n)(*items) if hasattr(n, "_fields") else tuple(items)
        return values[key]
    return go(node, depth, ())


def decode_state_specs(state, cfg: ModelConfig, ctx) -> dict:
    """The port's decode state (lists over layers) -> the same structure
    of specs: each leaf's rule taken at the reference's stacked shape, the
    stacked entries dropped (they are ``None`` for every rule)."""
    out = {}
    for k, node in state.items():
        depth = interop.LM_STATE_STACKED.get(k, 0)
        specs = {}
        for path, counts, leaf, key in _state_leaves(node, f"[{k!r}]", depth):
            spec = _leaf_spec(path, (*counts, *leaf.shape), ctx)
            if any(e is not None for e in spec[:depth]):
                raise ValueError(f"{path}: the reference shards a stacked "
                                 f"layer axis ({spec!r})")
            specs[key] = P(*spec[depth:])
        out[k] = _rebuild(node, depth, specs)
    return out


# ---------------------------------------------------------------------------
# the fake world and DTensor placement
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks in this process
    (collectives return without moving data), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group already exists in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def local_bytes(tree) -> int:
    """Bytes of the local shards (this rank's share) of a tree's tensors."""
    return sum(t.numel() * t.element_size()
               for t in hlo_analysis.local_tensors(tree))


def unit_layers(cfg: ModelConfig) -> int:
    """The depth of one repeating unit of ``cfg``'s stack: an xLSTM unit
    (``slstm_every`` blocks), a zamba2 unit (``attn_every`` Mamba2 blocks
    and the shared attention), a MoE's dense lead layers and one MoE
    layer, else one block.  Every layer past it repeats its ops."""
    if cfg.family == "ssm":
        return cfg.xlstm.slstm_every
    if cfg.family == "hybrid":
        return cfg.attn_every
    if cfg.family == "moe":
        return cfg.moe.first_dense_layers + 1
    return 1


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------
def _trace(fn, n_devices, resident):
    """Run ``fn`` under the op trace and ``CommDebugMode``, a long
    recurrence counted by its trip count (``hlo_analysis.by_trip_count``);
    returns (the ``OpTrace``, comm counts by op, seconds)."""
    from torch.distributed.tensor.debug import CommDebugMode

    def once():
        with CommDebugMode() as comm, hlo_analysis.OpTrace(
                n_devices, resident) as tr:
            fn()
        return tr, {str(k): v for k, v in comm.get_comm_counts().items()}

    t0 = time.perf_counter()
    tr, counts = hlo_analysis.by_trip_count(once)
    return tr, counts, time.perf_counter() - t0


def _cell(cfg: ModelConfig, shape: ShapeConfig, knobs: dict, mesh, ctx):
    """One cell's arguments as DTensors on ``mesh`` (the model's
    parameters, the batch, the AdamW state or the decode state) and the
    step to trace: ``(model, args, run)``."""
    model = build_model(cfg, device="meta")
    params = dict(model.named_parameters())
    p_specs = pspec.tree_specs(params, cfg, ctx, fsdp=knobs["fsdp"])
    batch = input_specs(cfg, shape)
    b_specs = batch_shardings(batch, cfg, ctx)
    distribute_parameters(model, p_specs, mesh)
    batch = distribute(batch, b_specs, mesh)
    args: list = [model, batch]

    if shape.kind == "train":
        tc = TrainConfig(
            microbatches=knobs["microbatches"],
            accum_dtype=knobs["accum_dtype"],
            opt=AdamWConfig(state_dtype=knobs["opt_dtype"]))
        o_specs = pspec.opt_state_specs(p_specs, params, ctx)
        opt = adamw_init(params, tc.opt)
        opt = AdamWState(step=opt.step,
                         mu=distribute(opt.mu, o_specs.mu, mesh),
                         nu=distribute(opt.nu, o_specs.nu, mesh))
        args.append(opt)
        # gradient accumulators live ZeRO-sharded (per-microbatch
        # reduce-scatter instead of all-reduce for replicated params)
        step = make_train_step(cfg, tc, ctx, accum_shardings={
            k: placements(s, mesh) for k, s in o_specs.mu.items()})

        def run():
            step(model, opt, batch)
    elif shape.kind == "prefill":
        def run():
            with torch.no_grad(), _replicated():
                model_mod.forward(model, batch, cfg, ctx)
    else:  # decode
        state = model_mod.init_decode_state(
            cfg, shape.global_batch, shape.seq_len, device="meta")
        state = distribute(state, decode_state_specs(state, cfg, ctx),
                           mesh)
        args.append(state)

        def run():
            with torch.no_grad(), _replicated():
                model_mod.decode_step(model, state, batch, cfg, ctx)
    return model, args, run


def _arg_bytes(model, args) -> int:
    return local_bytes([dict(model.named_parameters()), *args[1:]])


def _cell_config(arch: str, layers: int | None):
    cfg = get_arch(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg


def argument_bytes(arch: str, shape_name: str, multi_pod: bool,
                   layers: int | None = None) -> int:
    """A cell's ``argument_size_in_bytes`` (the local shards of its
    arguments on one device), without tracing the step."""
    cfg, shape = _cell_config(arch, layers), SHAPES[shape_name]
    knobs = cell_knobs(arch, shape)
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        ctx = make_ctx(mesh, sequence_parallel=knobs["sequence_parallel"])
        model, args, _ = _cell(cfg, shape, knobs, mesh, ctx)
        return _arg_bytes(model, args)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               save_trace: str | None = None,
               layers: int | None = None) -> dict:
    """One cell's record.  ``layers`` cuts the depth (the widths stay the
    arch's), for a quick check; the record says so."""
    cfg = _cell_config(arch, layers)
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_OK:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": "pure full-attention arch; 500k dense KV cache "
                          "needs sub-quadratic attention"}
    knobs = cell_knobs(arch, shape)
    n_dev = 512 if multi_pod else 256
    with fake_world(n_dev):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        ctx = make_ctx(mesh, sequence_parallel=knobs["sequence_parallel"])
        t0 = time.perf_counter()
        model, args, run = _cell(cfg, shape, knobs, mesh, ctx)
        arg_bytes = _arg_bytes(model, args)
        setup_s = time.perf_counter() - t0
        tr, comm, trace_s = _trace(run, n_dev, args)

    ana = tr.analysis
    if save_trace:
        with open(save_trace, "w") as f:
            for (kind, op, shp), (n, nb) in tr.records.items():
                f.write(f"{kind} {op} {list(shp)} x{n} {nb} B\n")
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "devices": n_dev,
        "status": "ok",
        "layers": cfg.num_layers,
        "knobs": knobs,
        "lower_s": round(setup_s + trace_s, 1),
        "compile_s": None,
        "compile_note": "nothing compiles: an eager op trace on meta "
                        "tensors over a fake process group",
        "memory": {
            "argument_size_in_bytes": arg_bytes,
            "temp_size_in_bytes": tr.peak_bytes,
            "temp_note": "eager estimate: the peak bytes of live local "
                         "storages made during the step, beyond the "
                         "arguments (hlo_analysis.OpTrace)",
        },
        "collectives": {
            "bytes": dict(ana.collective_bytes_by_kind),
            "counts": dict(ana.collective_counts),
            "total_bytes": sum(ana.collective_bytes_by_kind.values()),
            "comm_debug_counts": comm,
        },
        "analysis": {
            "flops": ana.flops,
            "hbm_bytes": ana.hbm_bytes,
            "collective_wire_bytes": ana.collective_wire_bytes,
            "collective_bytes_by_kind": ana.collective_bytes_by_kind,
            "collective_counts": ana.collective_counts,
            "bf16_upcast_bytes": ana.bf16_upcast_bytes,
            "ops": ana.ops,
            "notes": ana.notes[:10],
        },
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--depth", default="full", choices=["full", "unit"],
                    help="'unit' traces one repeating unit of layers "
                         "(unit_layers) at full width: every op the full "
                         "depth runs, in a fraction of the time")
    ap.add_argument("--save-trace", action="store_true",
                    help="write each cell's op trace (op, shape, count, "
                         "bytes) as text beside its record")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                trace_path = (os.path.join(args.out, tag + ".trace.txt")
                              if args.save_trace else None)
                print(f"=== {tag} ===", flush=True)
                try:
                    layers = (unit_layers(get_arch(arch))
                              if args.depth == "unit" else None)
                    r = lower_cell(arch, shape, mp, save_trace=trace_path,
                                   layers=layers)
                except Exception as e:   # one cell's failure is its record
                    r = {"arch": arch, "shape": shape,
                         "mesh": "2x16x16" if mp else "16x16",
                         "status": "error",
                         "error": f"{type(e).__name__}: {e}"[:2000],
                         "traceback": traceback.format_exc()[-2000:]}
                results.append(r)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(r, f, indent=1)
                if r["status"] == "ok":
                    mem = r["memory"]
                    print(f"  ok layers={r['layers']} lower={r['lower_s']}s "
                          f"args={mem['argument_size_in_bytes'] / 2**30:.2f}GiB "
                          f"temp~{mem['temp_size_in_bytes'] / 2**30:.2f}GiB "
                          f"flops={r['analysis']['flops']:.3g} "
                          f"coll={r['collectives']['total_bytes'] / 2**30:.2f}GiB",
                          flush=True)
                else:
                    print(f"  {r['status']}: {r.get('reason', r.get('error'))}",
                          flush=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\nDRYRUN: {n_ok} ok, {n_skip} skipped (documented), {n_err} errors")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
