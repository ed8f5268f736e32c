"""The port's sharding rules (``repro_torch.parallel``) against the JAX
reference's, on the CPU with no process group.

* ``logical`` over every logical axis, with 2-axis and 3-axis rules, with
  and without sequence parallelism, and the unknown-axis error: equal.
* ``tree_specs`` and ``opt_state_specs`` for all ten archs at full width
  on the 16 x 16 and 2 x 16 x 16 meshes, ``fsdp`` off and on: the port's
  per-layer specs, put back on the reference's stacked axes
  (``interop.lm_specs_to_reference``), equal the reference's spec trees
  leaf for leaf.  The reference's shapes come from
  ``jax.eval_shape(init_params)`` on an ``AbstractMesh``; the port's from
  a model on ``meta`` and a shape-only ``ShardingCtx``.
* each leaf's per-device shard under the DTensor placements of its spec:
  its shape equals ``NamedSharding(abstract_mesh, spec).shard_shape`` and
  its offset puts a tuple entry's axes major to minor (JAX's order), at
  the first, the last and a middle device.

Everything here is exact: the rules are integer arithmetic on shapes.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402
from torch.distributed.tensor._utils import (  # noqa: E402
    _compute_local_shape_and_global_offset)

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro.parallel import param_specs as j_pspec  # noqa: E402
from repro.parallel import sharding as j_sharding  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.parallel import param_specs as pspec  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
LOGICAL = (None, "d_model", "state", "seq", "batch", "vocab", "heads",
           "d_ff", "experts", "kv_heads", "head_dim", "zero")
CASES = [(a, m, f) for a in sorted(ARCHS) for m in MESHES
         for f in (False, True)]


def _ctxs(mesh):
    shape, names = MESHES[mesh]
    return (j_sharding.make_ctx(AbstractMesh(shape, names)),
            sharding.make_ctx(dict(zip(names, shape))))


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(reference shape tree, port ``{name: meta tensor}``) of an arch."""
    ref = jax.eval_shape(
        lambda: j_model.init_params(jax.random.PRNGKey(0), J_ARCHS[arch]))
    port = dict(build_model(ARCHS[arch], device="meta").named_parameters())
    return ref, port


def _as_tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, JP))


def _specs(arch, mesh, fsdp):
    (jctx, pctx), (ref, port) = _ctxs(mesh), _shapes(arch)
    cfg = ARCHS[arch]
    j_specs = j_pspec.tree_specs(ref, J_ARCHS[arch], jctx, fsdp=fsdp)
    p_specs = pspec.tree_specs(port, cfg, pctx, fsdp=fsdp)
    return jctx, pctx, ref, port, j_specs, p_specs


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("sequence_parallel", [False, True])
def test_logical_matches_reference(mesh, sequence_parallel):
    shape, names = MESHES[mesh]
    jr = j_sharding.make_ctx(AbstractMesh(shape, names),
                             sequence_parallel).rules
    pr = sharding.make_ctx(dict(zip(names, shape)), sequence_parallel).rules
    assert pr.dp == jr.dp
    for a in LOGICAL:
        assert tuple(sharding.logical(pr, a)) == tuple(
            j_sharding.logical(jr, a)), a
    assert tuple(sharding.logical(pr, *LOGICAL)) == tuple(
        j_sharding.logical(jr, *LOGICAL))
    for bad in ("layers", "bogus"):
        with pytest.raises(ValueError, match="unknown logical axis"):
            sharding.logical(pr, "batch", bad)
        with pytest.raises(ValueError, match="unknown logical axis"):
            j_sharding.logical(jr, "batch", bad)


@pytest.mark.parametrize("arch,mesh,fsdp", CASES)
def test_param_specs_match_reference(arch, mesh, fsdp):
    _, _, _, _, j_specs, p_specs = _specs(arch, mesh, fsdp)
    assert interop.lm_specs_to_reference(p_specs) == _as_tuples(j_specs)


@pytest.mark.parametrize("arch,mesh,fsdp", CASES)
def test_opt_state_specs_match_reference(arch, mesh, fsdp):
    jctx, pctx, ref, port, j_specs, p_specs = _specs(arch, mesh, fsdp)
    j_opt = j_pspec.opt_state_specs(j_specs, ref, jctx)
    p_opt = pspec.opt_state_specs(p_specs, port, pctx)
    assert tuple(p_opt.step) == tuple(j_opt.step) == ()
    want = _as_tuples(j_opt.mu)
    assert interop.lm_specs_to_reference(p_opt.mu) == want
    assert interop.lm_specs_to_reference(p_opt.nu) == _as_tuples(j_opt.nu)
    # zero_spec alone, on the port's per-layer leaves' reference shapes
    shapes = interop.lm_reference_shapes(port)
    for name, spec in p_specs.items():
        depth = len(shapes[name][1]) - len(spec)
        full = sharding.P(*([None] * depth), *spec)
        assert tuple(pspec.zero_spec(full, shapes[name][1], pctx)) == tuple(
            j_pspec.zero_spec(JP(*full), shapes[name][1], jctx)), name


def _coords(mesh_shape):
    last = tuple(n - 1 for n in mesh_shape)
    mid = tuple(n // 2 - 1 if n > 2 else 1 for n in mesh_shape)
    return [tuple(0 for _ in mesh_shape), last, mid]


def _jax_offset(shape, spec, sizes, names, coord):
    """Where JAX puts device ``coord``'s block: along a dim, the linear
    index of the device over the dim's axes, major to minor."""
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        idx, count = 0, 1
        for a in axes:
            i = names.index(a)
            idx, count = idx * sizes[i] + coord[i], count * sizes[i]
        out.append(idx * (n // count))
    return tuple(out)


@pytest.mark.parametrize("arch,mesh,fsdp", CASES)
def test_shard_shapes_match_named_sharding(arch, mesh, fsdp):
    jctx, pctx, _, port, _, p_specs = _specs(arch, mesh, fsdp)
    o_specs = pspec.opt_state_specs(p_specs, port, pctx).mu
    sizes, names = MESHES[mesh]
    am = AbstractMesh(sizes, names)
    for specs in (p_specs, o_specs):
        for name, p in port.items():
            spec, shape = specs[name], tuple(p.shape)
            pl = sharding.placements(spec, pctx.mesh)
            want = tuple(NamedSharding(am, JP(*spec)).shard_shape(shape))
            for coord in _coords(sizes):
                local, offset = _compute_local_shape_and_global_offset(
                    shape, sizes, list(coord), pl)
                assert tuple(local) == want, (name, coord)
                assert tuple(offset) == _jax_offset(
                    shape, spec, sizes, names, coord), (name, spec, coord)


def test_placements_order_and_errors():
    mesh = {"pod": 2, "data": 16, "model": 16}
    P = sharding.P
    assert sharding.placements(P(("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert sharding.placements(P(None, ("pod", "data", "model")), mesh) == (
        Shard(1), Shard(1), Shard(1))
    assert sharding.placements(P(None, None), mesh) == (Replicate(),) * 3
    # a mesh axis of size 1 holds the dim whole
    assert sharding.placements(P("data", "model"), {"data": 1, "model": 4}) \
        == (Replicate(), Shard(1))
    with pytest.raises(ValueError, match="axis order"):
        sharding.placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="used twice"):
        sharding.placements(P("model", "model"), mesh)


def test_no_leaf_is_sharded_across_layers():
    """Every rule leaves the stacked layer axes replicated for every arch,
    mesh and regime (were one not, ``tree_specs`` would raise)."""
    for arch, mesh, fsdp in CASES:
        jctx, _, ref, _, j_specs, _ = _specs(arch, mesh, fsdp)
        flat = jax.tree_util.tree_flatten_with_path(ref)[0]
        specs = jax.tree.leaves(j_specs, is_leaf=lambda x: isinstance(x, JP))
        zero = jax.tree.leaves(j_pspec.opt_state_specs(j_specs, ref, jctx).mu,
                               is_leaf=lambda x: isinstance(x, JP))
        for (path, _), s, z in zip(flat, specs, zero):
            depth = interop.LM_PARAM_STACKED.get(path[0].key, 0)
            assert all(e is None for e in tuple(s)[:depth]), (arch, path)
            assert all(e is None for e in tuple(z)[:depth]), (arch, path)


def test_layer_sharded_leaf_raises():
    """Under fsdp the reference shards the qkv biases' layer axis when the
    layer count divides over the data axes (``[fs(nd - 3), None,
    tpx(nd - 1)]`` on ``[L, H, dh]``): reduced qwen2 (2 layers) on a 2 x 1
    mesh.  The port no longer raises there: it holds each such leaf
    stacked (``stacked.blocks.attn.wq.b``) with the reference's spec,
    ``('data', 'model', None)`` on this mesh (the model axis has one
    rank, which divides every head count), and every other leaf, and the
    AdamW moments, equal the reference's too."""
    from repro.configs import reduced as j_reduced
    from repro_torch.configs import reduced

    shape, names = (2, 1), ("data", "model")
    jcfg, cfg = j_reduced(J_ARCHS["qwen2-0.5b"]), reduced(ARCHS["qwen2-0.5b"])
    jctx = j_sharding.make_ctx(AbstractMesh(shape, names))
    ref = jax.eval_shape(lambda: j_model.init_params(
        jax.random.PRNGKey(0), jcfg))
    j_specs = j_pspec.tree_specs(ref, jcfg, jctx, fsdp=True)
    assert tuple(j_specs["blocks"]["attn"]["wq"]["b"]) == (
        "data", "model", None)
    port = dict(build_model(cfg, device="meta").named_parameters())
    ctx = sharding.make_ctx(dict(zip(names, shape)))
    p_specs = pspec.tree_specs(port, cfg, ctx, fsdp=True)
    stacked = sorted(k for k in p_specs if k.startswith(interop.STACKED))
    assert stacked == [f"stacked.blocks.attn.{w}.b" for w in ("wk", "wq",
                                                             "wv")]
    assert p_specs["stacked.blocks.attn.wq.b"] == ("data", "model", None)
    assert interop.lm_specs_to_reference(p_specs) == _as_tuples(j_specs)
    j_opt = j_pspec.opt_state_specs(j_specs, ref, jctx)
    p_opt = pspec.opt_state_specs(p_specs, port, ctx)
    assert interop.lm_specs_to_reference(p_opt.mu) == _as_tuples(j_opt.mu)
    assert interop.lm_specs_to_reference(p_opt.nu) == _as_tuples(j_opt.nu)


def test_layer_axis_on_a_size_one_mesh_axis_is_dropped():
    """With one data rank and fsdp, every layer count divides the data
    size, so the reference names ``'data'`` on the qkv biases' layer
    axis: a layout that splits nothing.  The port drops it: its parameter
    specs equal the reference's with the stacked entries dropped, and its
    ZeRO moments' specs give the same placements (the reference's ZeRO
    rule sees ``'data'`` taken on the layer axis and adds nothing; the
    port's puts ``'data'`` on a trailing dim, which on one data rank
    splits nothing either)."""
    from repro.configs import reduced as j_reduced
    from repro_torch.configs import reduced

    shape, names = (1, 2), ("data", "model")
    jcfg, cfg = j_reduced(J_ARCHS["qwen2-0.5b"]), reduced(ARCHS["qwen2-0.5b"])
    jctx = j_sharding.make_ctx(AbstractMesh(shape, names))
    ref = jax.eval_shape(lambda: j_model.init_params(
        jax.random.PRNGKey(0), jcfg))
    j_specs = j_pspec.tree_specs(ref, jcfg, jctx, fsdp=True)
    assert tuple(j_specs["blocks"]["attn"]["wq"]["b"])[0] == "data"
    j_mu = j_pspec.opt_state_specs(j_specs, ref, jctx).mu
    port = dict(build_model(cfg, device="meta").named_parameters())
    ctx = sharding.make_ctx(dict(zip(names, shape)))
    p_specs = pspec.tree_specs(port, cfg, ctx, fsdp=True)
    p_mu = pspec.opt_state_specs(p_specs, port, ctx).mu
    ref_shapes = interop.lm_reference_shapes(port)
    for exact, want_tree, got in ((True, j_specs, p_specs),
                                  (False, j_mu, p_mu)):
        flat = dict(jax.tree_util.tree_flatten_with_path(
            want_tree, is_leaf=lambda x: isinstance(x, JP))[0])
        by_path = {"/".join(f"[{q.key!r}]" for q in k): v
                   for k, v in flat.items()}
        for name, (path, full) in ref_shapes.items():
            want = tuple(by_path[path])
            depth = len(full) - len(port[name].shape)
            if exact:
                assert tuple(got[name]) == want[depth:], (name, want)
            assert (sharding.placements(got[name], ctx.mesh)
                    == sharding.placements(want[depth:], ctx.mesh)), name
