"""The port's serving engine (``repro_torch.serving.engine``) and its
launcher against the JAX reference's: greedy tokens equal at ``reduced()``
size in float32, the stop token, the seeded temperature path, the
launcher on the CPU, no silent CPU path, and (``cuda``) the card against
the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_lm_parity as lm  # noqa: E402
from repro.serving.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402

from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import init_decode_state  # noqa: E402
from repro_torch.serving.engine import (ServeConfig, ServeEngine,  # noqa: E402
                                        make_serve_step)

B, PROMPT, NEW = 3, 6, 8


def prompts(cfg, seed=7):
    return np.random.default_rng(seed).integers(2, cfg.vocab_size,
                                                (B, PROMPT))


def engines(name, **scfg):
    """The reference's engine and the port's on the reference's
    parameters (float32, reduced), with the same ``ServeConfig``."""
    want = lm.reference(name)
    cref, cport = lm.cfg_pair(name)
    kw = dict(max_batch=B, max_seq=PROMPT + NEW + 4, **scfg)
    ref = JServeEngine(cref, jax.tree.map(jnp.asarray, want["params"]),
                       JServeConfig(**kw))
    port = ServeEngine(cport, lm.port_model(name, "float32", want["params"]),
                       ServeConfig(**kw), device="cpu")
    return ref, port


@pytest.mark.parametrize("name", ["qwen2-0.5b", "mixtral-8x7b",
                                  "xlstm-1.3b"])
def test_greedy_tokens_match_reference(name):
    ref, port = engines(name)
    p = prompts(ref.cfg)
    want = np.asarray(ref.generate(jnp.asarray(p), NEW))
    got = port.generate(torch.from_numpy(p), NEW)
    assert got.dtype == torch.int32 and got.shape == (B, NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    # the prefill's cache and last logits, as the reference's replay
    st_want, lg_want = ref.prefill(jnp.asarray(p))
    st, lg = port.prefill(torch.from_numpy(p))
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_want), **lm.TOL)
    np.testing.assert_array_equal(st["len"].numpy(), np.asarray(
        st_want["len"]))


def test_stop_token_matches_reference():
    """A stop token that one sequence emits mid-way: its later lanes
    hold the stop token, in both engines."""
    ref, _ = engines("xlstm-1.3b")
    p = prompts(ref.cfg)
    free = np.asarray(ref.generate(jnp.asarray(p), NEW))
    eos = int(free[0, 2])
    ref, port = engines("xlstm-1.3b", eos_token=eos)
    want = np.asarray(ref.generate(jnp.asarray(p), NEW))
    got = port.generate(torch.from_numpy(p), NEW).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 2:] == eos).all()


def test_temperature_is_seeded_and_in_range():
    _, cfg = lm.cfg_pair("qwen2-0.5b")
    model = build_model(cfg, device="cpu", seed=3)
    p = torch.from_numpy(prompts(cfg))

    def run(seed):
        eng = ServeEngine(cfg, model, ServeConfig(
            max_batch=B, max_seq=64, temperature=1.0, seed=seed),
            device="cpu")
        return eng.generate(p, 16)
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size


def test_serve_step_is_the_decode_step():
    _, cfg = lm.cfg_pair("qwen2-0.5b")
    model = build_model(cfg, device="cpu")
    tok = {"tokens": torch.ones((B, 1), dtype=torch.long)}
    with torch.no_grad():
        lg, st = make_serve_step(cfg)(model, model.init_decode_state(B, 8),
                                      tok)
        lg2, _ = model.decode_step(model.init_decode_state(B, 8), tok)
    assert torch.equal(lg, lg2) and int(st["pos"][0]) == 1


def test_launch_serve_on_the_cpu(capsys):
    out = serve_launch.main(["--device", "cpu", "--reduced", "--batch", "2",
                             "--prompt-len", "5", "--max-new", "6"])
    assert out.shape == (2, 6) and out.device.type == "cpu"
    assert "arch=qwen2-0.5b device=cpu" in capsys.readouterr().out


def test_no_silent_cpu_path(monkeypatch):
    """Without a card, every entry point raises unless asked for the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = lm.cfg_pair("qwen2-0.5b")
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, model, ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_decode_state(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_launch.main(["--reduced"])


@pytest.mark.cuda
def test_cuda_engine_matches_cpu():
    """The reduced qwen2-0.5b in float32 on the card against the CPU: the
    forward within 1e-3 (cuBLAS and the CPU order the sums differently)
    and the greedy tokens equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, cfg = lm.cfg_pair("qwen2-0.5b")
    cpu = build_model(cfg, device="cpu", seed=4)
    gpu = build_model(cfg, device="cpu", seed=4).to("cuda")
    p = torch.from_numpy(prompts(cfg))
    with torch.no_grad():
        want, _ = cpu({"tokens": p})
        got, _ = gpu({"tokens": p.cuda()})
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-3,
                               atol=1e-3)
    scfg = ServeConfig(max_batch=B, max_seq=PROMPT + NEW + 4)
    toks_cpu = ServeEngine(cfg, cpu, scfg, device="cpu").generate(p, NEW)
    toks_gpu = ServeEngine(cfg, gpu, scfg).generate(p, NEW)
    assert torch.equal(toks_gpu.cpu(), toks_cpu)
