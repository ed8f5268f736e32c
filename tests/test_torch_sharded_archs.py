"""The sharded-only forms that the production dry run's archs need
(``models/attention.py``, ``models/xlstm.py``, ``models/model.py``'s
pinned residual, the stacked qkv bias of ``parallel``) on real values:
two ``gloo`` ranks, each case's sharded forward, decode and train step
against the port's plain (``ctx=None``) ones from the same weights, all
in float32.

Cases (a reduced arch each; 4 sequences of 16 tokens and labels, a fifth
``IGNORE_LABEL``, from numpy seed 0, unless said otherwise):

* ``gqa``: reduced llama3-405b with 6 query heads and 3 KV heads on a
  ``(1, 2)`` mesh: the query heads shard over 2 model ranks, which do
  not divide the 3 KV heads (as 8 KV heads and 16 ranks at full width),
  so the grouped decode gathers the query heads and the chunk-local KV
  repeat takes the query's layout.
* ``xlstm``: reduced xlstm-1.3b with 3 heads (``d_model`` 96) on
  ``(1, 2)``: the mLSTM's head split and merge over 2 ranks that do not
  divide 3 heads, and ``log_sigmoid``'s DTensor strategies in the train
  step's backward.
* ``zamba2``: reduced zamba2-7b with 4-token SSD chunks on ``(1, 2)``,
  3 sequences (6 in the train step, microbatches of 3): left free, the
  residual sum's partial would be reduce-scattered onto the sequence (3
  rows do not split over 2 ranks), which the chunk loop then unbinds.
* ``stacked``: reduced qwen2-0.5b (2 layers) on a ``(2, 1)`` mesh with
  fsdp: the reference shards the qkv biases' layer axis over the data
  axis, and the port holds them stacked (ROADMAP Queue 3, repaired).

Bounds: the forward's logits and every decode step's logits within
rtol = atol = 1e-4 (float32 sums split over ranks add in another order);
the train step within the training slice's bounds
(``torch_train_parity.assert_step_close``).  Each case also runs with its
form taken out, where DTensor must refuse it: the form is what makes the
case run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_train_parity as tp  # noqa: E402
from torch_train_parity import one_thread  # noqa: E402,F401
from ranks import run_ranks  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.training.optimizer import AdamWState  # noqa: E402

TOL = 1e-4
BATCH, SEQ, CACHE, DECODE_STEPS = 6, 16, 8, 3

WORKER = r"""
import dataclasses, sys
import torch
import torch.distributed as tdist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import ARCHS, reduced
from repro_torch.launch.dryrun import batch_shardings, decode_state_specs
from repro_torch.models import attention, build_model, ssm, xlstm
from repro_torch.models import model as model_mod
from repro_torch.parallel import param_specs as pspec, sharding
from repro_torch.training.optimizer import AdamWConfig, AdamWState, adamw_init
from repro_torch.training.train_step import TrainConfig, make_train_step

path, rank, store = sys.argv[1], int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
tdist.init_process_group("gloo", init_method=f"file://{store}",
                         rank=rank, world_size=2)
full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
spec = torch.load(path + ".in", weights_only=True)
tc = TrainConfig(microbatches=spec["microbatches"],
                 opt=AdamWConfig(lr=spec["lr"]))


def tree_full(tree):
    if isinstance(tree, dict):
        return {k: tree_full(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_full(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            type(tree)(items)
    return full(tree)


def make_cfg(arch, over):
    over = dict(over)
    chunk = over.pop("ssm_chunk", None)
    cfg = dataclasses.replace(reduced(ARCHS[arch]), **over)
    if chunk:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               chunk=chunk))
    return cfg


def setup(cfg, mesh, fsdp, sharded):
    model = build_model(cfg, device="cpu", seed=0)
    params = {k: p.detach() for k, p in model.named_parameters()}
    opt = adamw_init(params, tc.opt)
    if not sharded:
        return model, opt, None, None
    ctx = sharding.make_ctx(mesh)
    ps = pspec.tree_specs(params, cfg, ctx, fsdp=fsdp)
    os_ = pspec.opt_state_specs(ps, params, ctx)
    opt = AdamWState(opt.step, sharding.distribute(opt.mu, os_.mu, mesh),
                     sharding.distribute(opt.nu, os_.nu, mesh))
    sharding.distribute_parameters(model, ps, mesh)
    acc = {k: sharding.placements(s, mesh) for k, s in os_.mu.items()}
    return model, opt, ctx, acc


def forward(cfg, model, batch, ctx):
    with torch.no_grad(), implicit_replication():
        return full(model_mod.forward(model, batch, cfg, ctx)[0])


def decode(cfg, model, tokens, ctx):
    b = tokens.shape[0]
    state = model_mod.init_decode_state(cfg, b, spec["cache"], device="cpu")
    if ctx is not None:
        state = sharding.distribute(
            state, decode_state_specs(state, cfg, ctx), ctx.mesh)
    out = []
    with torch.no_grad(), implicit_replication():
        for i in range(spec["decode_steps"]):
            tok = {"tokens": tokens[:, i:i + 1]}
            if ctx is not None:
                tok = sharding.distribute(tok, batch_shardings(tok, cfg, ctx),
                                          ctx.mesh)
            lg, state = model_mod.decode_step(model, state, tok, cfg, ctx)
            out.append(full(lg))
    return out, tree_full(state)


def without_form(case, cfg, mesh, fsdp, batch, tokens):
    # the case run with its sharded form taken out: the message DTensor
    # refuses it with (None if it ran), and for zamba2 whether a Mamba2
    # block received a pending partial sum, with the form and without
    saved, partial = [], []

    def patch(mod, name, value):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    def spy(x, *a, **k):
        partial.append(any(p.is_partial() for p in x.placements))
        return mamba(x, *a, **k)

    mamba = ssm.mamba2_forward
    patch(ssm, "mamba2_forward", spy)
    try:
        model, opt, ctx, acc = setup(cfg, mesh, fsdp, True)
        b = sharding.distribute(batch, batch_shardings(batch, cfg, ctx), mesh)
        if case == "zamba2":
            forward(cfg, model, b, ctx)
        with_form = any(partial)
        partial.clear()
        if case == "gqa":
            patch(attention, "split_uneven", lambda *a: False)
        elif case == "xlstm":
            patch(xlstm, "_batch_sharded", lambda y: y)
        elif case == "zamba2":
            patch(model_mod, "with_sharding", lambda ctx, x, *a: x)
        try:
            if case == "gqa":
                decode(cfg, model, tokens, ctx)
            elif case != "stacked":
                forward(cfg, model, b, ctx)
            msg = None
        except RuntimeError as e:
            msg = str(e)[:300]
        return dict(refused=msg, partial=(with_form, any(partial)))
    finally:
        for mod, name, value in reversed(saved):
            setattr(mod, name, value)


def round_trips(cfg, mesh, fsdp, path):
    # the stacked leaves carried both ways: interop to and from the
    # reference's tree, a checkpoint of the plain model restored onto the
    # stacked layout, and one of the stacked model restored plain
    from torch.distributed.tensor import distribute_tensor
    from repro_torch import interop
    from repro_torch.training import checkpoint as ckpt

    plain, _, _, _ = setup(cfg, mesh, fsdp, False)
    model, opt, ctx, _ = setup(cfg, mesh, fsdp, True)
    want = interop.lm_params_to_reference(plain)
    got = interop.lm_params_to_reference(model)
    flat = lambda t: {k: v for k, v in interop._paths(t)}
    same = lambda a, b: set(a) == set(b) and all(
        (a[k] == b[k]).all() for k in a)
    res = dict(to_reference=same(flat(want), flat(got)))
    g = torch.Generator().manual_seed(7)
    tree = {k: torch.randn(v.shape, generator=g)
            for k, v in interop.lm_tree_from_reference(want, "cpu").items()}
    moved = interop.lm_params_to_reference(tree)
    interop.lm_params_from_reference(model, moved)
    res["from_reference"] = same(flat(interop.lm_params_to_reference(model)),
                                 flat(moved))
    params = {k: p.detach() for k, p in plain.named_parameters()}
    if rank == 0:
        ckpt.save(path + ".plain", 1, {"params": params})
    tdist.barrier()
    specs = pspec.tree_specs(params, cfg, ctx, fsdp=fsdp)
    shard = {k: (mesh, sharding.placements(s, mesh)) for k, s in specs.items()}
    back = ckpt.restore(path + ".plain", 1, {"params": params},
                        shardings={"params": shard})["params"]
    res["restore_stacked"] = set(back) == set(specs) and all(
        torch.equal(v.to_local(), distribute_tensor(
            interop.lm_stack(params, specs)[k], mesh,
            v.placements).to_local()) for k, v in back.items())
    mine = {k: p.detach() for k, p in model.named_parameters()}
    ckpt.save(f"{path}.stacked{rank}", 1, {"params": mine})
    back = ckpt.restore(f"{path}.stacked{rank}", 1,
                        {"params": params})["params"]
    res["restore_plain"] = set(back) == set(params) and all(
        torch.equal(back[k], v) for k, v in
        interop.lm_unstack({k: full(t) for k, t in mine.items()}).items())
    return res


out = {}
try:
    for case, (arch, over, shape, fsdp, rows) in spec["cases"].items():
        cfg = make_cfg(arch, over)
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        # (forward and decode rows, train step rows)
        batch = {k: v[:rows[0]] for k, v in spec["batch"].items()}
        tokens = batch["tokens"]
        train_batch = {k: v[:rows[1]] for k, v in spec["batch"].items()}
        res = {}
        for sharded in (False, True):
            model, opt, ctx, acc = setup(cfg, mesh, fsdp, sharded)
            b = batch if ctx is None else sharding.distribute(
                batch, batch_shardings(batch, cfg, ctx), mesh)
            fwd = forward(cfg, model, b, ctx)
            dec, st = decode(cfg, model, tokens, ctx)
            step = make_train_step(cfg, tc, ctx, acc)
            model, opt, ctx, acc = setup(cfg, mesh, fsdp, sharded)
            b = train_batch if ctx is None else sharding.distribute(
                train_batch, batch_shardings(train_batch, cfg, ctx), mesh)
            opt, mt = make_train_step(cfg, tc, ctx, acc)(model, opt, b)
            res[sharded] = dict(
                fwd=fwd, dec=dec, state=st, step=full(opt.step),
                mt={k: full(v) for k, v in mt.items()},
                p={k: full(p).detach() for k, p in model.named_parameters()},
                mu={k: full(v) for k, v in opt.mu.items()},
                nu={k: full(v) for k, v in opt.nu.items()},
                stacked=sorted(k for k, _ in model.named_parameters()
                               if k.startswith("stacked.")))
        res.update(without_form(case, cfg, mesh, fsdp, batch, tokens))
        if case == "stacked":
            res["round_trips"] = round_trips(cfg, mesh, fsdp, path)
        out[case] = res
    if rank == 0:
        torch.save(out, path)
    print(f"RANK_OK {rank}")
finally:
    tdist.destroy_process_group()
"""

# case -> (arch, reduced-config overrides, mesh, fsdp, (forward and
# decode rows, train step rows)) (module docstring)
CASES = {
    "gqa": ("llama3-405b", dict(num_layers=2, num_heads=6, num_kv_heads=3,
                                dtype="float32"), (1, 2), False, (4, 4)),
    "xlstm": ("xlstm-1.3b", dict(d_model=96, num_heads=3, num_kv_heads=3,
                                 dtype="float32"), (1, 2), False, (4, 4)),
    "zamba2": ("zamba2-7b", dict(ssm_chunk=4, dtype="float32"), (1, 2),
               False, (3, 6)),
    "stacked": ("qwen2-0.5b", dict(dtype="float32"), (2, 1), True, (4, 4)),
}


def _cfg(case):
    import dataclasses

    from repro_torch.configs import ARCHS, reduced

    arch, over = CASES[case][:2]
    over = dict(over)
    chunk = over.pop("ssm_chunk", None)
    cfg = dataclasses.replace(reduced(ARCHS[arch]), **over)
    if chunk:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               chunk=chunk))
    return cfg


def _batch():
    from repro_torch.training.train_step import IGNORE_LABEL

    rng = np.random.default_rng(0)
    shape = (BATCH, SEQ)
    vocab = min(_cfg(c).vocab_size for c in CASES)
    tokens = rng.integers(0, vocab, shape, dtype=np.int32)
    labels = rng.integers(0, vocab, shape, dtype=np.int32)
    labels[rng.random(shape) < 0.2] = IGNORE_LABEL
    return tp.to_torch({"tokens": tokens, "labels": labels})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's plain and sharded runs, from one spawn of two ranks."""
    path = tmp_path_factory.mktemp("sharded_archs") / "runs.pt"
    batch = _batch()
    torch.save(dict(cases=CASES, batch=batch, tokens=batch["tokens"],
                    microbatches=tp.MICROBATCHES, lr=tp.LR, cache=CACHE,
                    decode_steps=DECODE_STEPS), f"{path}.in")
    # 3x the most of 6 suite runs on 4 cores (91.5 s), to end before the
    # 300 s limit of the test that sets this fixture up
    run_ranks(WORKER, [path], path.parent, n=2, timeout=270)
    return torch.load(path, weights_only=False)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_forward_matches_plain(case, runs):
    plain, got = runs[case][False], runs[case][True]
    assert got["fwd"].shape == plain["fwd"].shape
    torch.testing.assert_close(got["fwd"], plain["fwd"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_decode_matches_plain(case, runs):
    plain, got = runs[case][False], runs[case][True]
    assert len(got["dec"]) == DECODE_STEPS
    for i, (g, w) in enumerate(zip(got["dec"], plain["dec"])):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL,
                                   msg=lambda m: f"step {i}: {m}")
    for g, w in zip(torch.utils._pytree.tree_leaves(got["state"]),
                    torch.utils._pytree.tree_leaves(plain["state"])):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_plain(case, runs):
    plain, got = runs[case][False], runs[case][True]
    want = dict(step=int(plain["step"]),
                metrics={k: float(v) for k, v in plain["mt"].items()},
                mu=interop.lm_params_to_reference(plain["mu"]),
                nu=interop.lm_params_to_reference(plain["nu"]),
                new_params=interop.lm_params_to_reference(plain["p"]))
    tp.assert_step_close(want, AdamWState(got["step"], got["mu"],
                                          got["nu"]), got["p"], got["mt"])


@pytest.mark.parametrize("case", ["gqa", "xlstm"])
def test_cases_need_their_sharded_forms(case, runs):
    """Taken out, each case's form leaves a layout DTensor refuses: the
    uneven (KV heads, group) split of the query heads, the mLSTM's head
    split of a value dim sharded over more ranks than heads."""
    msg = runs[case]["refused"]
    assert msg is not None, case
    assert "unevenly" in msg, msg


def test_zamba2_case_takes_the_pinned_residual(runs):
    """Without the pinned residual the zamba2 case's Mamba2 blocks receive
    a pending partial sum (DTensor left the residual's reduction free; at
    full width it reduce-scatters it onto the sequence, which the chunk
    loop cannot unbind); with it, none does."""
    assert runs["zamba2"]["partial"] == (False, True)
    assert runs["zamba2"]["refused"] is None


def test_stacked_case_holds_the_reference_layout(runs):
    """The stacked case keeps its qkv biases as three stacked leaves,
    split over the data ranks on their layer axis, and the plain model
    none."""
    got = runs["stacked"]
    assert got[False]["stacked"] == []
    assert got[True]["stacked"] == [f"stacked.blocks.attn.{w}.b"
                                    for w in ("wk", "wq", "wv")]
    assert got[True]["p"]["stacked.blocks.attn.wq.b"].shape[0] == 2


def test_stacked_leaves_round_trip(runs):
    """``interop.lm_params_to_reference`` of the stacked model equals the
    plain model's tree and ``lm_params_from_reference`` loads a tree into
    it; a checkpoint of the plain model restores onto the stacked layout
    (``restore(..., shardings=)``, each rank its shard) and one saved from
    the stacked model restores into the plain per-layer tree, exactly."""
    assert runs["stacked"]["round_trips"] == dict(
        to_reference=True, from_reference=True, restore_stacked=True,
        restore_plain=True)
