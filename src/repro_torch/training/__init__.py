"""Training substrate: optimizer, train step, data, checkpointing, fault
tolerance (port of ``repro.training``).  Pure PyTorch; no
``torch.optim``."""
from .optimizer import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from .train_step import TrainConfig, make_train_step, loss_fn  # noqa: F401
