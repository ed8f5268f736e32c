"""One ``train_step`` (2 microbatches) of the port's xLSTM model on
``tests/test_archs_smoke.py``'s batch against the JAX reference's at
``reduced()`` size (metrics, parameters, ``mu``, ``nu``), and a bf16 step.
The gradient checks are in ``test_torch_train_xlstm.py``.
``tests/torch_train_parity.py`` holds the checks and derives their
bounds."""
import pytest

pytest.importorskip("torch")

import torch_train_parity as tp  # noqa: E402
from torch_train_parity import one_thread  # noqa: E402,F401

ARCHS = ["xlstm-1.3b"]


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_matches_reference(name):
    tp.check_train_step(name)


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_train_step(name):
    tp.check_bf16_step(name)
