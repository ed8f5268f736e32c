"""Training the xLSTM model (mLSTM and sLSTM units) of the port against the
JAX reference at ``reduced()`` size: float32 loss, aux and gradients
against ``jax.value_and_grad`` of the reference's ``_microbatch_loss``,
and remat on and off bit-equal.  The train step is in
``test_torch_train_xlstm_step.py`` (the reference's compile of each takes
half a minute here).  ``tests/torch_train_parity.py`` holds the checks and
derives their bounds."""
import pytest

pytest.importorskip("torch")

import torch_train_parity as tp  # noqa: E402
from torch_train_parity import one_thread  # noqa: E402,F401

ARCHS = ["xlstm-1.3b"]


@pytest.mark.parametrize("name", ARCHS)
def test_grads_match_reference(name):
    tp.check_grads(name)


@pytest.mark.parametrize("name", ARCHS)
def test_remat_grads_bit_equal(name):
    tp.check_remat(name)
