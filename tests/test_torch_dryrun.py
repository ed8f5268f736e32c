"""The port's production dry run (``repro_torch.launch.dryrun``) and
roofline report (``repro_torch.launch.roofline``) against the reference.

* qwen2-0.5b ``train_4k`` on the 16 x 16 mesh over a ``fake`` process
  group of 256 ranks ends ``ok``, at the arch's full width and cut to 2
  layers (the full 24 take two minutes of tracing; ``PERF.md`` records
  that run): its ``argument_size_in_bytes`` (the local shards of the
  parameters, the AdamW state and the batch) equals, exactly, the sum of
  the reference's ``NamedSharding(abstract_mesh, spec).shard_shape``
  bytes over its parameter, optimizer and batch specs at the same depth.
  ``decode_32k`` ends ``ok`` at full depth, and its argument bytes
  (parameters, decode state, batch) equal the reference's the same way.
* ``decode_state_specs`` for all ten archs at ``decode_32k``'s shapes on
  both production meshes: the port's per-layer specs, with the stacked
  layer axes put back, equal the reference's leaf for leaf.
* ``roofline.terms`` and ``markdown`` on a synthetic record, with the
  reference's hardware constants passed in, equal the reference's.

The fake group lives inside ``lower_cell`` (``fake_world`` destroys it);
each test checks that no process group is left behind.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as tdist  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.launch import roofline as j_roofline  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro.parallel import param_specs as j_pspec  # noqa: E402
from repro.parallel.sharding import make_ctx as j_make_ctx  # noqa: E402
from repro.training.optimizer import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.training.optimizer import adamw_init as j_adamw_init  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@functools.lru_cache(maxsize=None)
def _ref_dryrun():
    """The reference's dry-run module: it sets ``XLA_FLAGS`` when
    imported (jax is already up here, so it changes nothing in this
    process), which is put back at once."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jd
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jd


def _shard_bytes(tree, specs, mesh):
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
        x, (JP, NamedSharding)))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, s in zip(leaves, spec_leaves):
        s = s if isinstance(s, NamedSharding) else NamedSharding(mesh, s)
        total += int(np.prod(s.shard_shape(leaf.shape))) * leaf.dtype.itemsize
    return total


def reference_argument_bytes(arch, shape_name, layers=None):
    """Per-device bytes of the reference's jit arguments for one cell."""
    jd = _ref_dryrun()
    cfg = J_ARCHS[arch]
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    shape = J_SHAPES[shape_name]
    knobs = jd.cell_knobs(arch, shape)
    mesh = AbstractMesh(*MESHES["16x16"])
    ctx = j_make_ctx(mesh)
    ps = jax.eval_shape(lambda: j_model.init_params(
        jax.random.PRNGKey(0), cfg))
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
    else:
        st = jax.eval_shape(lambda: j_model.init_decode_state(
            cfg, shape.global_batch, shape.seq_len))
        total += _shard_bytes(st, jd.decode_state_specs(st, cfg, ctx), mesh)
    return total


@pytest.mark.parametrize("shape_name,layers", [("train_4k", 2),
                                               ("decode_32k", None)])
def test_qwen2_cell_ok_and_argument_bytes(shape_name, layers):
    r = dryrun.lower_cell("qwen2-0.5b", shape_name, False, layers=layers)
    assert not tdist.is_initialized()
    assert r["status"] == "ok"
    assert r["layers"] == (layers or ARCHS["qwen2-0.5b"].num_layers)
    assert r["devices"] == 256 and r["mesh"] == "16x16"
    assert r["compile_s"] is None
    assert r["memory"]["argument_size_in_bytes"] == reference_argument_bytes(
        "qwen2-0.5b", shape_name, layers)
    a = r["analysis"]
    assert a["flops"] > 0 and a["hbm_bytes"] > 0
    assert a["collective_wire_bytes"] > 0
    assert sum(a["collective_counts"].values()) == sum(
        r["collectives"]["comm_debug_counts"].values())
    assert a["bf16_upcast_bytes"] == 0


def _spec_at(tree, key):
    for i in key:
        tree = tree[i]
    return tree


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_state_specs_match_reference(arch, mesh):
    jd = _ref_dryrun()
    sizes, names = MESHES[mesh]
    shape = J_SHAPES["decode_32k"]
    cfg = J_ARCHS[arch]
    st = jax.eval_shape(lambda: j_model.init_decode_state(
        cfg, shape.global_batch, shape.seq_len))
    j_specs = jd.decode_state_specs(st, cfg, j_make_ctx(
        AbstractMesh(sizes, names)))
    flat = jax.tree_util.tree_flatten_with_path(
        j_specs, is_leaf=lambda x: isinstance(x, JP))[0]
    want = {"/".join(str(q) for q in path): tuple(s) for path, s in flat}

    pstate = model_mod.init_decode_state(
        ARCHS[arch], shape.global_batch, shape.seq_len, device="meta")
    p_specs = dryrun.decode_state_specs(
        pstate, ARCHS[arch], sharding.make_ctx(dict(zip(names, sizes))))
    got = {}
    for k, node in pstate.items():
        depth = dryrun.interop.LM_STATE_STACKED.get(k, 0)
        for path, _, _, key in dryrun._state_leaves(node, f"[{k!r}]", depth):
            spec = (None,) * depth + tuple(_spec_at(p_specs[k], key))
            assert got.setdefault(path, spec) == spec, path
    assert got == want


def _record(shape, **analysis):
    a = dict(flops=3.2e14, hbm_bytes=9.1e12, collective_wire_bytes=7.9e11,
             bf16_upcast_bytes=0.0)
    a.update(analysis)
    return {"arch": "qwen2-0.5b", "shape": shape, "devices": 256,
            "param_count": 493961216, "active_param_count": 493961216,
            "analysis": a}


@pytest.mark.parametrize("shape,analysis", [
    ("train_4k", {}),
    ("decode_32k", {"flops": 2.3e9, "hbm_bytes": 3.0e9,
                    "collective_wire_bytes": 6.4e8}),
    ("prefill_32k", {"collective_wire_bytes": 9e14}),
    ("train_4k", {"flops": 1e10, "hbm_bytes": 1e9,
                  "collective_wire_bytes": 1e3}),
])
def test_roofline_matches_reference(shape, analysis):
    r = _record(shape, **analysis)
    hw = dict(peak_flops=j_roofline.PEAK_FLOPS, hbm_bw=j_roofline.HBM_BW,
              link_bw=j_roofline.ICI_BW)
    got, want = roofline.terms(r, **hw), j_roofline.terms(r)
    assert got == want
    skipped = {"arch": "qwen2-0.5b", "shape": "long_500k",
               "status": "skipped", "reason": "pure full-attention arch"}
    assert roofline.markdown([(r, got), (skipped, None)]) == \
        j_roofline.markdown([(r, want), (skipped, None)])
    assert roofline.remedy(r, got) == j_roofline.remedy(r, want)
    assert roofline.model_flops_per_chip(r) == \
        j_roofline.model_flops_per_chip(r)


def test_roofline_h100_constants():
    """The defaults are the H100 SXM data sheet's, no TPU figure."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    r = _record("train_4k")
    t = roofline.terms(r)
    assert t["compute_s"] == r["analysis"]["flops"] / 989e12
    assert t["collective_s"] == r["analysis"]["collective_wire_bytes"] / 450e9


def test_fake_world_refuses_a_second_group_and_cleans_up():
    with dryrun.fake_world(4):
        assert tdist.get_world_size() == 4
        with pytest.raises(RuntimeError, match="already exists"):
            with dryrun.fake_world(4):
                pass
    assert not tdist.is_initialized()
