"""Wrapper for the subround kernel: ``SubroundOuts`` and the launch.

:func:`subround` launches the Hopper kernel (``kernel.cu``) on CUDA
tensors and refuses any other (``repro_torch.kernels`` runs the plain
version, ``ref.subround_ref``, where the kernel does not).  Any B and any
C: the kernel needs no padding, and the outputs have the caller's shapes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

I32, F32 = torch.int32, torch.float32


class SubroundOuts(NamedTuple):
    """Outputs of the fused subround op (the reference's 32, in order)."""

    hit: torch.Tensor          # int32[B]
    vhit: torch.Tensor         # int32[B]
    accepted: torch.Tensor     # int32[B]
    overflow: torch.Tensor     # int32[B]
    pop: torch.Tensor          # int32[C]
    st_valid: torch.Tensor     # int32[C]
    st_version: torch.Tensor   # int32[C]
    rt_client: torch.Tensor    # int32[C*S]
    rt_seq: torch.Tensor       # int32[C*S]
    rt_port: torch.Tensor      # int32[C*S]
    rt_ts: torch.Tensor        # float32[C*S]
    rt_acked: torch.Tensor     # int32[C*S]
    rt_kidx: torch.Tensor      # int32[C*S]
    qlen: torch.Tensor         # int32[C]
    front: torch.Tensor        # int32[C]
    rear: torch.Tensor         # int32[C]
    ob_live: torch.Tensor      # int32[C*F]
    ob_kidx: torch.Tensor      # int32[C*F]
    ob_version: torch.Tensor   # int32[C*F]
    ob_vlen: torch.Tensor      # int32[C*F]
    ob_frags: torch.Tensor     # int32[C]
    val_writer: torch.Tensor   # int32[C*F]
    val_written: torch.Tensor  # int32[C*F]
    served: torch.Tensor       # int32[C, J]
    g_client: torch.Tensor     # int32[C, J]
    g_seq: torch.Tensor        # int32[C, J]
    g_port: torch.Tensor       # int32[C, J]
    g_ts: torch.Tensor         # float32[C, J]
    g_kidx: torch.Tensor       # int32[C, J]
    line_kidx: torch.Tensor    # int32[C]
    line_vlen: torch.Tensor    # int32[C]
    line_version: torch.Tensor # int32[C]


_FLOAT_IN = {11, 19}              # ts, rt_ts
_FLOAT_OUT = {"rt_ts", "g_ts"}


def _out_shapes(b, c, s, f, j):
    kind = {"B": (b,), "C": (c,), "CS": (c * s,), "CF": (c * f,),
            "CJ": (c, j)}
    kinds = ("B", "B", "B", "B", "C", "C", "C", "CS", "CS", "CS", "CS", "CS",
             "CS", "C", "C", "C", "CF", "CF", "CF", "CF", "C", "CF", "CF",
             "CJ", "CJ", "CJ", "CJ", "CJ", "CJ", "C", "C", "C")
    return [kind[k] for k in kinds]


def _arg_shapes(b, c, s, f):
    """The 30 array arguments' shapes for one switch instance."""
    return ([(b, 4)] + [(b,)] * 11 + [(c, 4)] + [(c,)] * 3
            + [(c * s,)] * 6 + [(c,)] * 3 + [(c * f,)] * 4 + [(c,)])


# the 31 arguments' ranks in one instance: the 30 arrays and the budget
BASE_RANKS = tuple(len(shp) for shp in _arg_shapes(1, 1, 1, 1)) + (0,)


def _check_args(args, dev, b, c, s, f, j, lead):
    """Raise unless every array argument has its kernel's dtype and the
    shape ``lead + (one instance's shape)`` (``lead`` per argument) on
    ``dev``."""
    if c < 1 or min(s, f, j) < 1:
        raise ValueError(f"subround: need C, S, F, J >= 1 (C={c}, S={s}, "
                         f"F={f}, J={j})")
    for i, (a, shp) in enumerate(zip(args, _arg_shapes(b, c, s, f))):
        want_dt = F32 if i in _FLOAT_IN else I32
        shp = tuple(lead[i]) + shp
        if a.device != dev or a.dtype != want_dt or tuple(a.shape) != shp:
            raise ValueError(
                f"subround: argument {i} is {a.dtype}{tuple(a.shape)} on "
                f"{a.device}; the kernel takes {want_dt}{shp} on {dev}")


def _outputs(lead, b, c, s, f, j, dev):
    return [torch.empty(lead + shp, dtype=F32 if name in _FLOAT_OUT else I32,
                        device=dev)
            for name, shp in zip(SubroundOuts._fields,
                                 _out_shapes(b, c, s, f, j))]


def subround(
    hkey, want, wreq, inst, frag, nfrags, kidx, vlen, client, seq, port, ts,
    table_hkeys, occupied, st_valid, st_version,
    rt_client, rt_seq, rt_port, rt_ts, rt_acked, rt_kidx, qlen, front, rear,
    ob_live, ob_kidx, ob_version, ob_vlen, ob_frags,
    budget,
    queue_size: int, max_frags: int, max_serves: int, p: int | None = None,
) -> SubroundOuts:
    """The fused subround pass on the card, one launch of one block of 512
    threads per switch instance.

    ``p`` None: one instance, each argument of the shape
    :func:`_arg_shapes` gives (the budget a scalar).  ``p`` an int: ``p``
    instances, each argument with a leading point axis of ``p``, or
    without it where every point shares it (a stride of 0), and every
    output with the point axis."""
    args = [hkey, want, wreq, inst, frag, nfrags, kidx, vlen, client, seq,
            port, ts, table_hkeys, occupied, st_valid, st_version,
            rt_client, rt_seq, rt_port, rt_ts, rt_acked, rt_kidx, qlen,
            front, rear, ob_live, ob_kidx, ob_version, ob_vlen, ob_frags]
    s, f, j = queue_size, max_frags, max_serves
    dev = hkey.device
    if dev.type != "cuda":
        raise ValueError(f"subround: the kernel takes CUDA tensors, not "
                         f"{dev}")

    from . import kernel
    from repro_torch.kernels import LAUNCHES

    budget = torch.as_tensor(budget, device=dev).to(I32)
    ins = args + [budget]
    own = [p is not None and a.dim() > n for a, n in zip(ins, BASE_RANKS)]
    pts = 1 if p is None else p
    b, c = hkey.shape[-2], table_hkeys.shape[-2]
    _check_args(args, dev, b, c, s, f, j,
                lead=[(p,) if o else () for o in own[:30]])
    ins = [a.contiguous() for a in args] + [
        budget.reshape(pts if own[30] else 1).contiguous()]
    outs = _outputs(() if p is None else (p,), b, c, s, f, j, dev)
    ptrs = [a.data_ptr() for a in ins] + [o.data_ptr() for o in outs]
    strides = ([a[0].numel() if o else 0 for a, o in zip(ins, own)]
               + [o.numel() // pts for o in outs])
    kernel.launch(ptrs, strides, pts, b, c, s, f, j,
                  torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["subround"] += 1
    return SubroundOuts(*outs)
