"""The port's training launcher and example on the CPU: the launcher
writes atomic checkpoints and resumes from the latest, a resumed run
continues a straight one bit for bit, the example trains a few steps; no
silent CPU path; and (``cuda``) one reduced step on the card against the
CPU."""
import copy
import dataclasses
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training.data import DataConfig, SyntheticStream  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.training.train_step import (  # noqa: E402
    TrainConfig, make_train_step,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--device", "cpu", "--reduced", "--seq", "16", "--batch", "4"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_launcher_writes_and_resumes(tmp_path, capsys):
    d = str(tmp_path)
    out = train_launch.main(ARGS + ["--steps", "4", "--ckpt", d,
                                    "--ckpt-every", "2"])
    assert out["start"] == 0 and len(out["losses"]) == 4
    assert all(np.isfinite(out["losses"]))
    assert sorted(os.listdir(d)) == ["step_00000001", "step_00000003"]
    assert ckpt.latest(d) == 3
    for s in ("step_00000001", "step_00000003"):
        assert sorted(os.listdir(os.path.join(d, s))) == [
            "COMMITTED", "meta.json", "shard_00000.npz"]
    assert int(out["opt"].step) == 4

    # a longer run resumes from step 3 and takes steps 4 and 5
    res = train_launch.main(ARGS + ["--steps", "6", "--ckpt", d])
    assert "resumed from step 3" in capsys.readouterr().out
    assert res["start"] == 4 and len(res["losses"]) == 2
    assert int(res["opt"].step) == 6 and ckpt.latest(d) == 5


def test_resumed_launch_continues_straight_run(tmp_path):
    """The checkpoint the launcher resumes from holds every parameter and
    the AdamW state: 2 steps after a restore equal the same 2 steps run
    on in the process that wrote it (same schedule)."""
    d = str(tmp_path)
    out = train_launch.main(ARGS + ["--steps", "3", "--ckpt", d])
    cfg = reduced(ARCHS["qwen2-0.5b"])
    tc = TrainConfig(microbatches=2, opt=AdamWConfig(
        lr=3e-3, warmup_steps=5, total_steps=3))
    step = make_train_step(cfg, tc)
    ds = SyntheticStream(DataConfig(cfg.vocab_size, 16, 4), device="cpu")
    model, opt = out["model"], out["opt"]
    fresh = build_model(cfg, device="cpu", seed=5)
    like = {"params": dict(fresh.named_parameters()),
            "opt": adamw_init(dict(fresh.named_parameters()), tc.opt)}
    state = ckpt.restore(d, ckpt.latest(d), like)
    with torch.no_grad():
        for k, p in fresh.named_parameters():
            p.copy_(state["params"][k])
    opt_r = state["opt"]
    for i in (3, 4):
        opt, _ = step(model, opt, ds.batch(i))
        opt_r, _ = step(fresh, opt_r, ds.batch(i))
    for (k, a), b in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), k
    assert all(torch.equal(opt.nu[k], opt_r.nu[k]) for k in opt.nu)


def test_example_trains_tiny():
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", os.path.join(ROOT, "examples", "train_lm_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    first, last = mod.main(["--tiny", "--device", "cpu", "--steps", "6"])
    assert np.isfinite(last) and last < first


def test_no_silent_cpu_path(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_launch.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticStream(DataConfig(100, 8, 2))


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu():
    """One reduced qwen2-0.5b step in float32 (2 microbatches) on the card
    against the CPU: loss, grad norm, parameters and moments within 1e-3
    (cuBLAS and the CPU order the sums differently)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = dataclasses.replace(reduced(ARCHS["qwen2-0.5b"]), dtype="float32")
    tc = TrainConfig(microbatches=2, opt=AdamWConfig(lr=1e-3))
    cpu = build_model(cfg, device="cpu", seed=4)
    gpu = copy.deepcopy(cpu).to("cuda")
    batch = SyntheticStream(DataConfig(cfg.vocab_size, 32, 4),
                            device="cpu").batch(0)
    step = make_train_step(cfg, tc)
    o_c, m_c = step(cpu, adamw_init(dict(cpu.named_parameters()), tc.opt),
                    batch)
    o_g, m_g = step(gpu, adamw_init(dict(gpu.named_parameters()), tc.opt),
                    {k: v.cuda() for k, v in batch.items()})
    tol = dict(rtol=1e-3, atol=1e-3)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m_g[k]), float(m_c[k]), **tol)
    for (k, a), b in zip(gpu.named_parameters(), cpu.parameters()):
        np.testing.assert_allclose(a.detach().cpu().numpy(),
                                   b.detach().numpy(), **tol, err_msg=k)
    for k in o_c.mu:
        np.testing.assert_allclose(o_g.mu[k].cpu().numpy(),
                                   o_c.mu[k].numpy(), **tol, err_msg=k)
        np.testing.assert_allclose(o_g.nu[k].cpu().numpy(),
                                   o_c.nu[k].numpy(), **tol, err_msg=k)
