"""Training the dense models of the port against the JAX reference at
``reduced()`` size: float32 loss, aux and gradients against
``jax.value_and_grad`` of the reference's ``_microbatch_loss``; one
``train_step`` (2 microbatches) on ``tests/test_archs_smoke.py``'s batch
(metrics, parameters, ``mu``, ``nu``); a bf16 step; remat on and off bit-
equal. ``tests/torch_train_parity.py`` holds the checks and derives their
bounds."""
import pytest

pytest.importorskip("torch")

import torch_train_parity as tp  # noqa: E402
from torch_train_parity import one_thread  # noqa: E402,F401

ARCHS = ["llama3-405b", "mistral-large-123b", "qwen2-0.5b", "minitron-4b"]


@pytest.mark.parametrize("name", ARCHS)
def test_grads_match_reference(name):
    tp.check_grads(name)


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_matches_reference(name):
    tp.check_train_step(name)


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_train_step(name):
    tp.check_bf16_step(name)


@pytest.mark.parametrize("name", ARCHS)
def test_remat_grads_bit_equal(name):
    tp.check_remat(name)
