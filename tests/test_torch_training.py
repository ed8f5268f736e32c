"""The port's training stack, as ``tests/test_training.py`` holds the
reference's, at its sizes and bounds: convergence, accumulation
equivalence, schedule, data determinism and sharding, checkpoint/restart,
elastic rescale, straggler stats; and a resumed run bit-equal to a
straight one on the CPU."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training.data import DataConfig, SyntheticStream  # noqa: E402
from repro_torch.training.fault_tolerance import (  # noqa: E402
    StragglerStats, TrainSupervisor, plan_rescale,
)
from repro_torch.training.optimizer import (  # noqa: E402
    AdamWConfig, adamw_init, schedule,
)
from repro_torch.training.train_step import (  # noqa: E402
    TrainConfig, make_train_step,
)

CPU = "cpu"


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg():
    return reduced(ARCHS["qwen2-0.5b"])


def test_loss_decreases():
    cfg = small_cfg()
    model = build_model(cfg, device=CPU)
    tc = TrainConfig(microbatches=2,
                     opt=AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60))
    step = make_train_step(cfg, tc)
    opt = adamw_init(dict(model.named_parameters()), tc.opt)
    ds = SyntheticStream(DataConfig(cfg.vocab_size, seq_len=64,
                                    global_batch=8), device=CPU)
    losses = []
    for i in range(30):
        opt, mt = step(model, opt, ds.batch(i))
        losses.append(float(mt["loss"]))
    assert losses[-1] < 0.7 * losses[0]


def test_grad_accumulation_equivalence():
    cfg = dataclasses.replace(small_cfg(), dtype="float32")
    ds = SyntheticStream(DataConfig(cfg.vocab_size, seq_len=32,
                                    global_batch=8), device=CPU)
    batch = ds.batch(0)
    outs = {}
    for mb in (1, 2, 4):
        model = build_model(cfg, device=CPU, seed=0)
        tc = TrainConfig(microbatches=mb, opt=AdamWConfig(lr=1e-3))
        _, mt = make_train_step(cfg, tc)(
            model, adamw_init(dict(model.named_parameters()), tc.opt), batch)
        outs[mb] = ([p.detach().numpy().copy() for p in model.parameters()],
                    float(mt["loss"]))
    for mb in (2, 4):
        for a, b in zip(outs[1][0], outs[mb][0]):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    at = lambda s: float(schedule(torch.tensor(s, dtype=torch.int32), cfg))
    assert at(0) == 0.0
    assert abs(at(10) - 1.0) < 1e-6
    assert at(100) <= 0.1 + 1e-6


def test_data_determinism_and_sharding():
    dc = DataConfig(vocab_size=100, seq_len=16, global_batch=8, seed=3)
    ds = SyntheticStream(dc, device=CPU)
    a = ds.batch(5)
    b = SyntheticStream(dc, device=CPU).batch(5)
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].dtype == torch.int32
    s0 = ds.batch(5, num_shards=2, shard=0)
    s1 = ds.batch(5, num_shards=2, shard=1)
    assert s0["tokens"].shape == (4, 16)
    assert not torch.equal(s0["tokens"], s1["tokens"])
    assert not torch.equal(ds.batch(6)["tokens"], a["tokens"])


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.ones((2,), dtype=torch.bfloat16)}}
    ckpt.save(d, 3, tree)
    assert ckpt.latest(d) == 3
    like = {"w": torch.zeros(3, 4), "nested": {
        "b": torch.zeros((2,), dtype=torch.bfloat16)}}
    back = ckpt.restore(d, 3, like)
    assert back["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(back["w"], tree["w"])
    assert torch.equal(back["nested"]["b"], tree["nested"]["b"])
    # torn checkpoint (no COMMITTED) is invisible
    os.makedirs(os.path.join(d, "step_00000009"))
    assert ckpt.latest(d) == 3


def test_supervisor_restart_resumes_exactly(tmp_path):
    d = str(tmp_path)
    state = torch.zeros((3,))

    def step_fn(s, i):
        return s + i

    # full uninterrupted run as the reference
    ref = state
    for i in range(7):
        ref = step_fn(ref, i)

    # crashed run: supervisor checkpointed at step 4, "crash" before 7
    sup = TrainSupervisor(ckpt_dir=d, ckpt_every=5)
    _ = sup.run(state, step_fn, num_steps=5)  # saves step 4 and final (4)
    sup2 = TrainSupervisor(ckpt_dir=d, ckpt_every=5)
    restored, start = sup2.restore(torch.zeros((3,)))
    assert start == 5
    resumed = sup2.run(restored, step_fn, num_steps=7, start_step=start)
    np.testing.assert_allclose(resumed.numpy(), ref.numpy())


def test_plan_rescale():
    p = plan_rescale(global_batch=256, new_num_hosts=16, max_per_shard=8)
    assert p.data_parallel == 16 and p.per_shard_batch == 16
    assert p.per_shard_batch // p.microbatches <= 8
    p = plan_rescale(global_batch=256, new_num_hosts=12, max_per_shard=64)
    assert 256 % p.data_parallel == 0  # shrunk to a divisor


def test_straggler_detection():
    s = StragglerStats()
    assert not s.update(1.0)
    for _ in range(5):
        assert not s.update(1.0)
    assert s.update(5.0)          # 5x slower than EWMA
    assert s.count == 1


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_resume_is_bit_equal(tmp_path, state_dtype):
    """6 steps straight against 3 steps, a checkpoint of the parameters
    and the AdamW state, a restore into a fresh model and 3 more steps:
    parameters and moments bit-equal (the CPU runs are deterministic)."""
    cfg = small_cfg()
    tc = TrainConfig(microbatches=2, opt=AdamWConfig(
        lr=3e-3, warmup_steps=2, total_steps=6, state_dtype=state_dtype))
    ds = SyntheticStream(DataConfig(cfg.vocab_size, seq_len=16,
                                    global_batch=4), device=CPU)
    step = make_train_step(cfg, tc)

    def run(model, opt, steps):
        for i in steps:
            opt, _ = step(model, opt, ds.batch(i))
        return opt

    straight = build_model(cfg, device=CPU, seed=3)
    opt_s = run(straight, adamw_init(dict(straight.named_parameters()),
                                     tc.opt), range(6))

    first = build_model(cfg, device=CPU, seed=3)
    opt = run(first, adamw_init(dict(first.named_parameters()), tc.opt),
              range(3))
    ckpt.save(str(tmp_path), 2, {"params": dict(first.named_parameters()),
                                 "opt": opt})
    fresh = build_model(cfg, device=CPU, seed=9)
    like = {"params": dict(fresh.named_parameters()),
            "opt": adamw_init(dict(fresh.named_parameters()), tc.opt)}
    state = ckpt.restore(str(tmp_path), ckpt.latest(str(tmp_path)), like)
    with torch.no_grad():
        for k, p in fresh.named_parameters():
            p.copy_(state["params"][k])
    assert int(state["opt"].step) == 3
    opt_r = run(fresh, state["opt"], range(3, 6))
    for (k, a), b in zip(straight.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), k
    for k in opt_s.mu:
        assert opt_r.mu[k].dtype == opt_s.mu[k].dtype
        assert torch.equal(opt_r.mu[k], opt_s.mu[k]), k
        assert torch.equal(opt_r.nu[k], opt_s.nu[k]), k
