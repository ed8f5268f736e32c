"""The port's sharded training path (``make_train_step(cfg, tc, ctx,
accum_shardings)``, ``checkpoint.restore(..., shardings=...)``) on the CPU
over ``gloo``.

* The train step, on a one-rank group and a 1 x 1 ``('data','model')``
  mesh: the parameters as DTensors of ``tree_specs``, the AdamW moments
  and the gradient accumulators in the ZeRO placements of
  ``opt_state_specs``, the batch split over the data axis (on one rank
  every placement is ``Replicate()``: ``sharding.placements``).  A reduced
  qwen2-0.5b and a reduced mixtral-8x7b (MoE) take one step (2
  microbatches of 2 sequences: DTensor cannot flatten a sharded batch dim
  of global size 1) on ``torch_train_parity.grad_batch`` for seeds 0 and 1,
  stacked.  Bounds:
  bit-equal to the port's ``ctx=None`` step (metrics, parameters, ``mu``,
  ``nu``): on one rank every redistribution is a no-op and the same local
  ops run in the same order; and within ``torch_train_parity``'s train-
  step bounds (metrics rtol 1e-4, moments and parameters entry by entry
  from the gradient bound) of the reference's ``make_train_step``
  under ``make_host_mesh()`` and ``make_ctx``, whose sharding constraints
  change nothing on one device.
* The train step on two ``gloo`` ranks, each DTensor-only form taken on
  real values: a ``(1, 2)`` mesh (model-sharded: vocab-sharded logits
  and the loss's gather, per-head matmuls for weights sharded on their
  head dim) and a ``(2, 1)`` mesh (data-sharded: the batch, its
  microbatch split, ``F.embedding`` of sharded tokens, ZeRO accumulators
  filled by reduce-scatter), with ``fsdp`` off and on, for a reduced
  qwen2-0.5b (3 layers; 3 query heads and 1 KV head, so that on 2 model
  ranks its attention weights shard their head dim, as full-width
  qwen2-0.5b's 14 and 2 heads do on 16) and a reduced mixtral-8x7b (3
  layers: under fsdp 2 layers would let the reference shard a stacked
  layer axis).  One step of 2 microbatches (4 sequences of 12 tokens,
  the gradient check's batch shape) from the same start as the port's
  ``ctx=None`` step, held to it within ``torch_train_parity``'s train-step
  bounds: float32 sums split over ranks add in another order, so bits
  need not hold.  The split is the reference's global one (microbatch i
  is rows [2i, 2i + 2)): a rank-local split regroups the rows and moves
  the loss and the MoE capacity drops beyond the bounds.
* Elastic restore, two ``gloo`` processes: a checkpoint saved from a plain
  model and its AdamW state, restored onto a ``(2, 1)`` mesh in the
  fsdp parameter placements and the ZeRO moment placements: each rank's
  local shard equals its half of the saved array (exact: a copy).
* The decode step's sharded cache write, on a ``(2, 1)`` mesh (batch
  sharded) and a ``(1, 2)`` mesh (sequence sharded): each rank's local
  cache equals its slice of the plain in-place write (exact).
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as tdist  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

import torch_train_parity as tp  # noqa: E402
from torch_train_parity import one_thread  # noqa: E402,F401

from repro.launch.mesh import make_host_mesh as j_host_mesh  # noqa: E402
from repro.parallel import param_specs as j_pspec  # noqa: E402
from repro.parallel.sharding import make_ctx as j_make_ctx  # noqa: E402
from repro.training.optimizer import adamw_init as j_adamw_init  # noqa: E402
from repro.training.train_step import (  # noqa: E402
    make_train_step as j_make_train_step)

from repro_torch.launch.dryrun import batch_shardings  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.parallel import param_specs as pspec  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.sharding import P as P_  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    AdamWConfig, AdamWState, adamw_init)
from repro_torch.training.train_step import (  # noqa: E402
    TrainConfig, make_train_step)

HERE = os.path.dirname(os.path.abspath(__file__))
ARCHS = ["qwen2-0.5b", "mixtral-8x7b"]
_STEPS: dict = {}


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh():
    """A one-rank gloo group and its 1 x 1 mesh, destroyed after the
    module."""
    tdist.init_process_group("gloo",
                             init_method=f"tcp://127.0.0.1:{free_port()}",
                             rank=0, world_size=1)
    try:
        yield make_host_mesh(device_type="cpu")
    finally:
        tdist.destroy_process_group()
        _STEPS.clear()


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _tc():
    return TrainConfig(microbatches=tp.MICROBATCHES,
                       opt=AdamWConfig(lr=tp.LR))


def _batch(cfg):
    """``grad_batch`` for seeds 0 and 1, stacked: 4 sequences."""
    a, b = tp.grad_batch(cfg, 0), tp.grad_batch(cfg, 1)
    return {k: np.concatenate([a[k], b[k]], axis=1 if k == "mrope_pos"
                              else 0) for k in a}


def _steps(name, mesh):
    """(plain, sharded) port steps from the reference's parameters:
    each (opt state, {name: parameter}, metrics), plain tensors."""
    if name in _STEPS:
        return _STEPS[name]
    cfg, pcfg = tp.cfg_pair(name)
    batch = tp.to_torch(_batch(cfg))
    out = []
    for sharded in (False, True):
        model = tp.port_model(name, tp.ref_params(name))
        params = dict(model.named_parameters())
        opt = adamw_init(params, _tc().opt)
        if not sharded:
            step, b = make_train_step(pcfg, _tc()), batch
        else:
            ctx = sharding.make_ctx(mesh)
            p_specs = pspec.tree_specs(params, pcfg, ctx)
            o_specs = pspec.opt_state_specs(p_specs, params, ctx)
            opt = AdamWState(opt.step,
                             sharding.distribute(opt.mu, o_specs.mu, mesh),
                             sharding.distribute(opt.nu, o_specs.nu, mesh))
            sharding.distribute_parameters(model, p_specs, mesh)
            b = sharding.distribute(batch, batch_shardings(batch, pcfg, ctx),
                                    mesh)
            step = make_train_step(pcfg, _tc(), ctx, accum_shardings={
                k: sharding.placements(s, mesh)
                for k, s in o_specs.mu.items()})
            assert all(isinstance(p, DTensor) for p in model.parameters())
        opt, mt = step(model, opt, b)
        out.append((AdamWState(_full(opt.step),
                               {k: _full(v) for k, v in opt.mu.items()},
                               {k: _full(v) for k, v in opt.nu.items()}),
                    {k: _full(p).detach() for k, p in
                     model.named_parameters()},
                    {k: _full(v) for k, v in mt.items()}))
    _STEPS[name] = tuple(out)
    return _STEPS[name]


def reference_sharded_step(name):
    """The reference's step on :func:`_batch` under its host mesh and
    ``make_ctx``, the accumulators in the ZeRO shardings (numpy)."""
    cfg, _ = tp.cfg_pair(name)
    tc = tp._jtc()
    params = tp.ref_params(name)
    mesh = j_host_mesh()
    ctx = j_make_ctx(mesh)
    p_specs = j_pspec.tree_specs(params, cfg, ctx)
    o_specs = j_pspec.opt_state_specs(p_specs, params, ctx)
    acc = jax.tree.map(lambda s: NamedSharding(mesh, s), o_specs.mu,
                       is_leaf=lambda x: isinstance(x, JP))
    step = jax.jit(j_make_train_step(cfg, tc, ctx, accum_shardings=acc))
    p2, o2, mt = step(params, j_adamw_init(params, tc.opt),
                      tp.to_jax(_batch(cfg)))
    npy = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(params=npy(params), new_params=npy(p2), mu=npy(o2.mu),
                nu=npy(o2.nu), step=int(o2.step),
                metrics={k: float(v) for k, v in mt.items()})


@pytest.mark.parametrize("name", ARCHS)
def test_sharded_step_bit_equal_to_plain(name, mesh):
    (opt_a, p_a, mt_a), (opt_b, p_b, mt_b) = _steps(name, mesh)
    for k in mt_a:
        assert torch.equal(mt_b[k], mt_a[k]), k
    assert int(opt_b.step) == int(opt_a.step) == 1
    for k in p_a:
        assert torch.equal(p_b[k], p_a[k]), k
        assert torch.equal(opt_b.mu[k], opt_a.mu[k]), k
        assert torch.equal(opt_b.nu[k], opt_a.nu[k]), k


@pytest.mark.parametrize("name", ARCHS)
def test_sharded_step_matches_reference(name, mesh):
    want = reference_sharded_step(name)
    opt, params, mt = _steps(name, mesh)[1]
    tp.assert_step_close(want, opt, params, mt)


WORKER = r"""
import dataclasses, sys
import numpy as np, torch
import torch.distributed as tdist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import build_model
from repro_torch.models.attention import _cache_write
from repro_torch.parallel import param_specs as pspec, sharding
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import AdamWConfig, adamw_init

path, rank, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
torch.set_num_threads(1)
tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                         rank=rank, world_size=2)


def part(full, placements, mesh):
    # the slice of ``full`` this rank holds: each Shard(d) splits dim d
    # into as many equal blocks as its mesh dim has ranks
    out = full
    for p, n, c in zip(placements, mesh.shape, mesh.get_coordinate()):
        if isinstance(p, Shard):
            out = out.chunk(n, dim=p.dim)[c]
    return out


try:
    # 3 layers: with 2 (divisible by the data size) the reference would
    # shard the qkv biases' layer axis under fsdp, which a per-layer leaf
    # cannot be (tests/test_torch_parallel.py)
    cfg = dataclasses.replace(reduced(ARCHS["qwen2-0.5b"]), num_layers=3)
    model = build_model(cfg, device="cpu", seed=3)
    params = {k: p.detach() for k, p in model.named_parameters()}
    opt = adamw_init(params, AdamWConfig())
    g = torch.Generator().manual_seed(4)      # the same on every rank
    opt = opt._replace(mu={k: torch.randn(v.shape, generator=g)
                           for k, v in opt.mu.items()})
    if rank == 0:
        ckpt.save(path, 7, {"params": params, "opt": opt})
    tdist.barrier()
    mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
    ctx = sharding.make_ctx(mesh)
    p_specs = pspec.tree_specs(params, cfg, ctx, fsdp=True)
    o_specs = pspec.opt_state_specs(p_specs, params, ctx)
    pl = lambda specs: {k: (mesh, sharding.placements(s, mesh))
                        for k, s in specs.items()}
    shard = {"params": pl(p_specs),
             "opt": type(opt)(None, pl(o_specs.mu), pl(o_specs.nu))}
    got = ckpt.restore(path, ckpt.latest(path),
                       {"params": params, "opt": opt}, shardings=shard)
    n_sharded = 0
    for tree, want, specs in ((got["params"], params, p_specs),
                              (got["opt"].mu, opt.mu, o_specs.mu),
                              (got["opt"].nu, opt.nu, o_specs.nu)):
        for k, t in tree.items():
            assert isinstance(t, DTensor), k
            exp = part(want[k], t.placements, mesh)
            assert torch.equal(t.to_local(), exp), (k, t.placements)
            n_sharded += isinstance(t.placements[0], Shard)
    assert n_sharded > 0
    assert not isinstance(got["opt"].step, DTensor)

    # the sharded cache write: batch-sharded, then sequence-sharded
    g = torch.Generator().manual_seed(5)
    b, t, h, dh = 4, 8, 2, 3
    cache = torch.randn(b, t, h, dh, generator=g)
    val = torch.randn(b, 1, h, dh, generator=g)
    idx = torch.tensor([0, 7, 3, 4], dtype=torch.int32)
    want = _cache_write(cache.clone(), val, idx)
    for shape, cpl in (((2, 1), [Shard(0), Replicate()]),
                       ((1, 2), [Replicate(), Shard(1)])):
        m = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        dc = distribute_tensor(cache.clone(), m, cpl)
        rep = [Replicate(), Replicate()]
        out = _cache_write(dc, distribute_tensor(val, m, rep),
                           distribute_tensor(idx, m, rep))
        assert out is dc
        assert torch.equal(dc.to_local(),
                           part(want, cpl, m)), shape
    print(f"RANK_OK {rank} {n_sharded}")
finally:
    tdist.destroy_process_group()
"""


def run_two_ranks(worker, path, timeout=240):
    """``worker`` as two spawned gloo ranks (argv: ``path``, rank, port);
    fails unless both print ``RANK_OK <rank>``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(HERE, "..", "src"),
                                         HERE])
    env["OMP_NUM_THREADS"] = "1"
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(path), str(r), str(port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0 and f"RANK_OK {r}" in out, (r, rc, out, err[-3000:])


def test_elastic_restore_and_sharded_cache_write(tmp_path):
    run_two_ranks(WORKER, tmp_path / "ckpt")


STEP_WORKER = r"""
import dataclasses, sys
import torch
import torch.distributed as tdist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from repro_torch.configs import ARCHS, reduced
from repro_torch.launch.dryrun import batch_shardings
from repro_torch.models import build_model
from repro_torch.parallel import param_specs as pspec, sharding
from repro_torch.training.optimizer import AdamWConfig, AdamWState, adamw_init
from repro_torch.training.train_step import TrainConfig, make_train_step

path, rank, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
torch.set_num_threads(1)
tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                         rank=rank, world_size=2)
full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
spec = torch.load(path + ".in", weights_only=True)
tc = TrainConfig(microbatches=spec["microbatches"],
                 opt=AdamWConfig(lr=spec["lr"]))
out = {}
try:
    for shape in spec["meshes"]:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        ctx = sharding.make_ctx(mesh)
        for arch, over in spec["overrides"].items():
            cfg = dataclasses.replace(reduced(ARCHS[arch]), **over)
            batch = spec["batches"][arch]
            for fsdp in (False, True):
                res = {}
                for sharded in (False, True):
                    model = build_model(cfg, device="cpu", seed=0)
                    params = {k: p.detach()
                              for k, p in model.named_parameters()}
                    opt = adamw_init(params, tc.opt)
                    step, b = make_train_step(cfg, tc), batch
                    if sharded:
                        ps = pspec.tree_specs(params, cfg, ctx, fsdp=fsdp)
                        os_ = pspec.opt_state_specs(ps, params, ctx)
                        opt = AdamWState(
                            opt.step,
                            sharding.distribute(opt.mu, os_.mu, mesh),
                            sharding.distribute(opt.nu, os_.nu, mesh))
                        sharding.distribute_parameters(model, ps, mesh)
                        b = sharding.distribute(
                            batch, batch_shardings(batch, cfg, ctx), mesh)
                        step = make_train_step(cfg, tc, ctx, {
                            k: sharding.placements(s, mesh)
                            for k, s in os_.mu.items()})
                    opt, mt = step(model, opt, b)
                    res[sharded] = dict(
                        step=full(opt.step),
                        mt={k: full(v) for k, v in mt.items()},
                        p={k: full(p).detach()
                           for k, p in model.named_parameters()},
                        mu={k: full(v) for k, v in opt.mu.items()},
                        nu={k: full(v) for k, v in opt.nu.items()})
                out[f"{shape[0]}x{shape[1]}-{arch}-{fsdp}"] = res
    if rank == 0:
        torch.save(out, path)
    print(f"RANK_OK {rank}")
finally:
    tdist.destroy_process_group()
"""
TWO_RANK_MESHES = ((1, 2), (2, 1))
# the reduced arch of each case (module docstring)
TWO_RANK_OVERRIDES = {
    "qwen2-0.5b": dict(num_layers=3, num_heads=3, num_kv_heads=1,
                       dtype="float32"),
    "mixtral-8x7b": dict(num_layers=3, dtype="float32"),
}
TWO_RANK_CASES = [f"{a}x{b}-{arch}-{fsdp}" for a, b in TWO_RANK_MESHES
                  for arch in TWO_RANK_OVERRIDES for fsdp in (False, True)]


def two_rank_case(arch):
    """(cfg, batch) of the two-rank step: the reduced arch, and 4
    sequences of 12 random tokens and labels (a fifth ``IGNORE_LABEL``)
    from seed 0."""
    import dataclasses

    from repro_torch.configs import ARCHS as T_ARCHS
    from repro_torch.configs import reduced
    from repro_torch.training.train_step import IGNORE_LABEL

    cfg = dataclasses.replace(reduced(T_ARCHS[arch]),
                              **TWO_RANK_OVERRIDES[arch])
    rng = np.random.default_rng(0)
    shape = (2 * tp.MICROBATCHES, tp.S)
    tokens = rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)
    labels = rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)
    labels[rng.random(shape) < 0.2] = IGNORE_LABEL
    return cfg, tp.to_torch({"tokens": tokens, "labels": labels})


@pytest.fixture(scope="module")
def two_rank_steps(tmp_path_factory):
    """Every two-rank case's plain and sharded step, from one spawn."""
    path = tmp_path_factory.mktemp("two_rank") / "steps.pt"
    torch.save(dict(meshes=TWO_RANK_MESHES, overrides=TWO_RANK_OVERRIDES,
                    microbatches=tp.MICROBATCHES, lr=tp.LR,
                    batches={a: two_rank_case(a)[1]
                             for a in TWO_RANK_OVERRIDES}), f"{path}.in")
    run_two_ranks(STEP_WORKER, path, timeout=400)
    return torch.load(path, weights_only=True)


@pytest.mark.parametrize("case", TWO_RANK_CASES)
def test_two_rank_step_matches_plain(case, two_rank_steps):
    from repro_torch import interop

    res = two_rank_steps[case]
    plain, got = res[False], res[True]
    want = dict(step=int(plain["step"]),
                metrics={k: float(v) for k, v in plain["mt"].items()},
                mu=interop.lm_params_to_reference(plain["mu"]),
                nu=interop.lm_params_to_reference(plain["nu"]),
                new_params=interop.lm_params_to_reference(plain["p"]))
    tp.assert_step_close(want, AdamWState(got["step"], got["mu"],
                                          got["nu"]), got["p"], got["mt"])


def test_two_rank_cases_take_the_sharded_forms():
    """The cases reach the forms they are there for: on 2 model ranks the
    qwen2 case's attention weights shard their head dim (the per-head
    matmuls of ``layers.sharded_inside``) and mixtral's shard heads; the
    vocab is model-sharded; on 2 data ranks the batch is sharded."""
    from repro_torch.models import build_model

    mesh = {"data": 1, "model": 2}
    ctx = sharding.make_ctx(mesh)
    for arch, inside in (("qwen2-0.5b", True), ("mixtral-8x7b", False)):
        cfg, batch = two_rank_case(arch)
        params = dict(build_model(cfg, device="meta").named_parameters())
        specs = pspec.tree_specs(params, cfg, ctx)
        for leaf in ("wq", "wk", "wo"):
            spec = specs[f"blocks.0.attn.{leaf}.w"]
            assert (spec[2] == "model") is inside, (arch, leaf, spec)
            assert (spec[1] == "model") is not inside, (arch, leaf, spec)
        assert specs["embed.table"][0] == "model"
    dctx = sharding.make_ctx({"data": 2, "model": 1})
    assert batch_shardings(batch, cfg, dctx)["tokens"] == P_("data", None)
