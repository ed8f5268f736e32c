"""Quickstart on the PyTorch port: the OrbitCache data plane in a minute.

The twin of ``examples/quickstart.py``: builds a switch, preloads a hot
set, pushes reads through it, and shows orbit lines serving queued
requests (cloning), write invalidation (coherence) and the miss path.
Runs on the CUDA card (each switch step is one subround kernel launch);
``--cpu`` runs the plain PyTorch version instead.

    python examples/quickstart_torch.py [--cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core.controller import CacheController, ControllerConfig
from repro_torch.core.hashing import hash128_u32
from repro_torch.core.switch import switch_step
from repro_torch.core.types import (
    OP_F_REP, OP_R_REQ, OP_W_REQ, empty_batch, init_switch_state,
    resolve_device,
)
from repro_torch.kvstore.store import synth_value

PAD = 256


def packets(dev, ops, keys, **kw):
    """A batch of ``len(ops)`` valid packets (padded to 8 lanes)."""
    n = len(ops)
    pk = empty_batch(max(n, 8), value_pad=PAD, device=dev)
    k = torch.tensor(keys, dtype=torch.int32, device=dev)
    lanes = torch.arange(n, dtype=torch.int32, device=dev)
    fields = dict(op=torch.tensor(ops, dtype=torch.int32, device=dev),
                  kidx=k, hkey=hash128_u32(k), seq=lanes, client=lanes % 4,
                  valid=torch.ones(n, dtype=torch.bool, device=dev), **kw)
    for f, v in fields.items():
        a = getattr(pk, f).clone()
        a[:n] = v
        pk = pk._replace(**{f: a})
    return pk


def main():
    dev = resolve_device("cpu" if "--cpu" in sys.argv else None)
    budget = torch.tensor(100, dtype=torch.int32, device=dev)
    sw = init_switch_state(num_entries=8, queue_size=4, value_pad=PAD,
                           device=dev)
    ctrl = CacheController(ControllerConfig(active_size=8))

    # controller installs the hot set {0..3}; servers answer with F-REPs
    sw, fetches = ctrl.preload(sw, np.arange(4, dtype=np.int32))
    ks = torch.tensor([k for k, _ in fetches], dtype=torch.int32, device=dev)
    pk = packets(dev, [OP_F_REP] * 4, list(range(4)),
                 flag=torch.ones(4, dtype=torch.int32, device=dev),
                 vlen=torch.full((4,), 128, dtype=torch.int32, device=dev),
                 val=synth_value(ks, torch.zeros_like(ks), PAD))
    sw, out = switch_step(sw, pk, budget, 4)
    print(f"installed {int(out.stats.n_install)} orbit lines "
          f"(cache packets now circulating)")

    # a burst of reads for hot key 0: ONE orbit line serves all of them
    sw, out = switch_step(sw, packets(dev, [OP_R_REQ] * 4, [0] * 4),
                          budget, 4)
    print(f"burst of 4 reads for key 0: hits={int(out.stats.n_hit)} "
          f"served-by-orbit={int(out.stats.n_served)} (PRE cloning)")

    # a write invalidates; reads fall through to the server until the
    # write reply carries the new value back
    sw, out = switch_step(sw, packets(dev, [OP_W_REQ], [0]), budget, 4)
    print(f"write to key 0: FLAG={int(out.flag[0])} "
          f"valid={bool(sw.state.valid[0])} "
          f"line-live={bool(sw.orbit.live[0])}")

    sw, out = switch_step(sw, packets(dev, [OP_R_REQ], [0]), budget, 4)
    print(f"read while invalid: routed-to-server={int(out.route[0]) == 1} "
          f"(coherence: stale value can never be served)")

    sw, out = switch_step(sw, packets(dev, [OP_R_REQ], [1000]), budget, 4)
    print(f"read of uncached key: hit={int(out.stats.n_hit)} -> server")
    print("OK")


if __name__ == "__main__":
    main()
