"""The production dry run (``repro_torch.launch.dryrun``) over every arch,
shape and production mesh, against the reference's ``repro.launch.dryrun``.

* Every arch x shape x mesh (80 cells): where the reference skips a cell
  (``long_500k`` on the pure full-attention archs) the port skips it;
  elsewhere the port's ``argument_size_in_bytes`` (the local shards of
  the parameters, the batch, and the AdamW state or the decode state on
  one device; ``dryrun.argument_bytes``, no trace) equals, exactly, the
  sum of the reference's ``NamedSharding(abstract_mesh, spec)
  .shard_shape`` bytes over the same leaves at full depth.
* One cell per sharded-only form ends ``ok`` at a depth this suite can
  afford (the port README's "Sharding and the dry run"): mixtral-8x7b
  ``decode_32k`` (8 KV heads under 32 query heads sharded over 16 ranks:
  the grouped decode gathers the query heads), xlstm-1.3b ``decode_32k``
  at one unit (4 heads over 16 ranks: the mLSTM's head split and merge)
  and zamba2-7b ``prefill_32k`` cut to one Mamba2 block (the chunked
  scan behind the pinned residual), on the 16 x 16 mesh.
* ``hlo_analysis.by_trip_count``: a reduced xLSTM's forward and backward
  at a 20-step sequence (plain meta tensors, and meta DTensors on a
  (1, 2) mesh of a ``fake`` group), its sLSTM loop traced for 2 and 3
  steps and the rest counted by the trip count, equals a full trace:
  FLOPs, HBM bytes, wire bytes, collectives, op count and every per-op
  record, exactly; its live-storage peak is the stretch's, at most the
  full trace's.
"""
import contextlib
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as tdist  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import LONG_CONTEXT_OK as J_LONG_OK  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro.parallel import param_specs as j_pspec  # noqa: E402
from repro.parallel.sharding import make_ctx as j_make_ctx  # noqa: E402
from repro.training.optimizer import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.training.optimizer import adamw_init as j_adamw_init  # noqa: E402

from test_torch_dryrun import MESHES, _ref_dryrun, _shard_bytes  # noqa: E402
from torch_train_parity import one_thread  # noqa: E402,F401

from repro_torch.configs import ARCHS, SHAPES, reduced  # noqa: E402
from repro_torch.launch import dryrun, hlo_analysis  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402

CELLS = [(a, s, m) for a in sorted(ARCHS) for s in SHAPES for m in MESHES]


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jax.eval_shape(lambda: j_model.init_params(
        jax.random.PRNGKey(0), J_ARCHS[arch]))


def reference_argument_bytes(arch, shape_name, mesh_name):
    """Per-device bytes of the reference's jit arguments for one cell."""
    jd = _ref_dryrun()
    cfg, shape = J_ARCHS[arch], J_SHAPES[shape_name]
    knobs = jd.cell_knobs(arch, shape)
    mesh = AbstractMesh(*MESHES[mesh_name])
    ctx = j_make_ctx(mesh)
    ps = _ref_params(arch)
    specs = j_pspec.tree_specs(ps, cfg, ctx, fsdp=knobs["fsdp"])
    batch = jd.input_specs(cfg, shape)
    total = _shard_bytes(ps, specs, mesh) + _shard_bytes(
        batch, jd.batch_shardings(batch, cfg, ctx, mesh), mesh)
    if shape.kind == "train":
        opt = jax.eval_shape(lambda p: j_adamw_init(p, JAdamWConfig(
            state_dtype=knobs["opt_dtype"])), ps)
        o_specs = j_pspec.opt_state_specs(specs, ps, ctx)
        total += _shard_bytes(opt.step, o_specs.step, mesh)
        total += _shard_bytes(opt.mu, o_specs.mu, mesh)
        total += _shard_bytes(opt.nu, o_specs.nu, mesh)
    elif shape.kind == "decode":
        st = jax.eval_shape(lambda: j_model.init_decode_state(
            cfg, shape.global_batch, shape.seq_len))
        total += _shard_bytes(st, jd.decode_state_specs(st, cfg, ctx), mesh)
    return total


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_argument_bytes_match_reference(arch, shape, mesh):
    multi = mesh == "2x16x16"
    if shape == "long_500k" and arch not in J_LONG_OK:
        r = dryrun.lower_cell(arch, shape, multi)
        assert r["status"] == "skipped"
        return
    got = dryrun.argument_bytes(arch, shape, multi)
    assert not tdist.is_initialized()
    assert got == reference_argument_bytes(arch, shape, mesh)


@pytest.mark.parametrize("arch,shape,layers", [
    ("mixtral-8x7b", "decode_32k", None),
    ("xlstm-1.3b", "decode_32k", None),
    ("zamba2-7b", "prefill_32k", 1),
])
def test_sharded_form_cell_ok(arch, shape, layers):
    cfg = ARCHS[arch]
    layers = layers or dryrun.unit_layers(cfg)
    r = dryrun.lower_cell(arch, shape, False, layers=layers)
    assert not tdist.is_initialized()
    assert r["status"] == "ok", r.get("error")
    assert r["layers"] == layers
    assert r["memory"]["argument_size_in_bytes"] == dryrun.argument_bytes(
        arch, shape, False, layers=layers)
    assert r["analysis"]["flops"] > 0


def _xlstm_step(sharded):
    """A reduced xLSTM's forward and backward at a 20-step sequence, as a
    function to trace, on meta tensors (DTensors on a (1, 2) mesh of the
    current group when ``sharded``)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.parallel import param_specs as pspec
    from repro_torch.parallel import sharding

    cfg = dataclasses.replace(reduced(ARCHS["xlstm-1.3b"]), dtype="float32")
    model = build_model(cfg, device="meta").requires_grad_(True)
    batch = {"tokens": torch.empty((2, 20), dtype=torch.int32,
                                   device="meta")}
    ctx = None
    if sharded:
        mesh = init_device_mesh("cpu", (1, 2),
                                mesh_dim_names=("data", "model"))
        ctx = sharding.make_ctx(mesh)
        sharding.distribute_parameters(model, pspec.tree_specs(
            dict(model.named_parameters()), cfg, ctx), mesh)
        batch = sharding.distribute(batch, dryrun.batch_shardings(
            batch, cfg, ctx), mesh)

    params = list(model.parameters())

    def run():
        with implicit_replication():
            logits, _ = model_mod.forward(model, batch, cfg, ctx)
            torch.autograd.grad(logits.float().sum(), params)
    return run


def _summary(tr, counts):
    a = tr.analysis
    return dict(flops=a.flops, hbm=a.hbm_bytes, wire=a.collective_wire_bytes,
                by_kind=a.collective_bytes_by_kind,
                coll=a.collective_counts, ops=a.ops, peak=tr.peak_bytes,
                records={k: v for k, v in tr.records.items() if v[0]},
                comm=counts)


@pytest.mark.parametrize("sharded", [False, True])
def test_trip_count_equals_full_trace(sharded):
    from torch.distributed.tensor.debug import CommDebugMode

    def trace(run):
        def once():
            with CommDebugMode() as comm, hlo_analysis.OpTrace(2) as tr:
                run()
            return tr, {str(k): v for k, v in comm.get_comm_counts().items()}
        return once

    with dryrun.fake_world(2) if sharded else contextlib.nullcontext():
        run = _xlstm_step(sharded)
        tr, counts = hlo_analysis.by_trip_count(trace(run))
        got = _summary(tr, counts)
        full = _summary(*trace(run)())     # as warm as by_trip_count's
    assert any("recurrence" in n and "of 20" in n for n in tr.analysis.notes)
    assert got.pop("peak") <= full.pop("peak")
    assert got == full
    assert full["ops"] > 0 and full["flops"] > 0
    assert (full["wire"] > 0) is sharded


def test_recurrence_runs_every_step_outside_a_trip_count():
    assert hlo_analysis.recurrence(7) == range(7)
    seen = []

    def trace():
        seen.append(list(hlo_analysis.recurrence(9)))
        tr = hlo_analysis.OpTrace()
        tr.analysis.ops = 5 + 3 * len(seen[-1])
        return tr, {}

    tr, _ = hlo_analysis.by_trip_count(trace)
    assert seen == [[0, 1, 2], [0, 1], [0, 1, 2]]
    assert tr.analysis.ops == 5 + 3 * 9
