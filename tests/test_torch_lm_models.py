"""The port's dense, audio and vision-language models against the JAX
reference at ``reduced()`` size: forward logits, 4 decode steps (logits
and state, with and without a cache that wraps), bf16 forwards, the
configs, and the port's own decode-equals-forward
(``tests/torch_lm_parity.py`` holds the checks and their tolerances)."""
import pytest

pytest.importorskip("torch")

import torch_lm_parity as lm  # noqa: E402

ARCHS = ["llama3-405b", "mistral-large-123b", "qwen2-0.5b", "minitron-4b",
         "musicgen-large", "qwen2-vl-7b"]


@pytest.mark.parametrize("name", ARCHS)
def test_config_matches_reference(name):
    lm.check_config(name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_reference(name, dtype):
    lm.check_forward(name, dtype)


@pytest.mark.parametrize("cache_len", [8, 3])
@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_reference(name, cache_len):
    """cache_len 3: the fourth step writes slot 0 again (a wrap)."""
    lm.check_decode(name, cache_len)


def test_decode_matches_forward():
    lm.check_decode_matches_forward("qwen2-0.5b")
