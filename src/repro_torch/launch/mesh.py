"""Production mesh definitions (port of ``repro.launch.mesh``).

``make_production_mesh`` is a FUNCTION (importing this module starts no
process group): 16x16 = 256 devices per pod ``('data','model')``;
multi-pod adds a leading ``'pod'`` axis -> (2,16,16) = 512.  Both build a
``torch.distributed`` ``DeviceMesh`` over the current process group,
whose world size must match (the dry run's ``fake`` group of 256 or 512).

The reference's ``make_mesh_compat`` is a jax-version shim and has no
counterpart.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """Small ``('data','model')`` mesh over the ranks of the current
    process group (tests / examples)."""
    n = dist.get_world_size()
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))
