"""LM substrate: PyTorch model definitions for the assigned architectures
(dense / MoE / MLA / SSM / xLSTM / hybrid / audio / VLM), port of
``repro.models``."""
from .model import Model, build_model  # noqa: F401
