"""Plain PyTorch version of the reply_values kernel: the value bytes of
``server.server_step``'s reply lanes, as the window computed them before
the kernel (the reference computes them in ``jnp`` in its
``server_step``; no Pallas kernel)."""
from __future__ import annotations

import torch

from repro_torch.kvstore.store import synth_value


def reply_values_ref(kidx, version, vlen, carries_val, max_frags: int,
                     pad: int):
    """uint8[..., n * cap * max_frags, pad] for ``[..., n, cap]`` lanes
    (leading axes broadcast: an input the points share has none).

    Fragment ``j`` of a lane holds ``synth_value(kidx, version, pad,
    offset=j * pad)`` in its first ``clamp(vlen - j * pad, 0, pad)`` bytes
    when ``carries_val``, and zeros elsewhere.  Lanes that are not live
    are not masked: the caller's ``valid`` flags them.
    """
    lanes = torch.broadcast_shapes(kidx.shape, version.shape, vlen.shape,
                                   carries_val.shape)
    lead, (n, cap), f = lanes[:-2], lanes[-2:], max_frags
    dev = kidx.device
    shape = lead + (n, cap, f)
    frag = torch.arange(f, dtype=torch.int32, device=dev)
    frag_off = frag * pad
    frag_vlen = torch.clamp(vlen[..., None] - frag_off, 0, pad)
    val = synth_value(kidx[..., None].expand(shape),
                      version[..., None].expand(shape), pad,
                      offset=frag_off.expand(shape))
    keep = ((torch.arange(pad, device=dev) < frag_vlen[..., None])
            & carries_val[..., None, None])
    val = torch.where(keep, val, 0).to(torch.uint8)
    return val.reshape(lead + (n * cap * f, pad))
