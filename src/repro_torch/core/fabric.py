"""Cross-rack spine fabric primitives (port of ``repro.core.fabric``).

R racks hang off one spine switch.  This module holds the pure,
scheme-agnostic pieces of that topology:

* **Key homing** — every rack owns a full copy of the local keyspace; the
  spine keys on the global identity ``kidx * n_racks + home``.
* **Locality draws** — per-lane target racks: local with probability
  ``local_frac`` (a carry scalar), else uniform over the other racks.  The
  port takes the draws ``(u, o)`` from a source (:mod:`repro_torch.kvstore.
  fabric_sim`'s target sources) and applies the reference's rule here, so
  ``local_frac >= 1.0`` keeps every lane local whatever the source.
* **One-hot lane exchange** — masked lanes compact into fixed-width lane
  buffers in lane order (the scatter-free unique writer); overflow beyond
  a buffer's width is dropped and counted.

Every function is shape-static, mask-gated and vmap-clean: the batched
fabric runs it under ``torch.func.vmap`` over its points.
"""
from __future__ import annotations

import torch

from .scatter_free import unique_writer

I32 = torch.int32


# ---------------------------------------------------------------------------
# key homing
# ---------------------------------------------------------------------------
def global_key(kidx: torch.Tensor, home: torch.Tensor,
               n_racks: int) -> torch.Tensor:
    """Pack a (local key, home rack) pair into the global key identity."""
    return kidx * n_racks + home


def split_global_key(gkidx: torch.Tensor, n_racks: int,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unpack a global key identity into ``(local kidx, home rack)``
    (floor division and remainder, as ``jnp``'s ``//`` and ``%``)."""
    return gkidx // n_racks, gkidx % n_racks


# ---------------------------------------------------------------------------
# locality draws
# ---------------------------------------------------------------------------
def source_racks(n_racks: int, ndim: int, device) -> torch.Tensor:
    """int32 ``[R, 1, ...]`` rack index broadcastable over ``ndim`` axes."""
    return torch.arange(n_racks, dtype=I32, device=device).reshape(
        (n_racks,) + (1,) * (ndim - 1))


def targets_from_draws(u: torch.Tensor | None, o: torch.Tensor | None,
                       n_racks: int, local_frac: torch.Tensor,
                       shape: tuple[int, ...], device) -> torch.Tensor:
    """Per-lane target rack, int32 ``shape`` (``shape[0]`` the source
    rack): the reference's ``draw_targets`` rule on the draws ``u``
    (float32 uniforms in [0, 1)) and ``o`` (int32 in ``[0, R - 1)``).  One
    rack takes no draw (``u`` and ``o`` None)."""
    src = source_racks(n_racks, len(shape), device).expand(shape)
    if n_racks == 1:
        return src
    other = o + (o >= src).to(I32)    # uniform over the n_racks - 1 others
    return torch.where(u < local_frac, src, other)


# ---------------------------------------------------------------------------
# one-hot lane exchange
# ---------------------------------------------------------------------------
def compact_slots(mask: torch.Tensor, width: int,
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Claim consecutive destination slots for the masked lanes of
    ``mask`` bool[N], in lane order; lanes beyond ``width`` are dropped.
    Returns ``(writer int32[width], written bool[width], dropped
    int32[])``."""
    m = mask.to(I32)
    order = torch.cumsum(m, 0, dtype=I32) - m
    dest = torch.where(mask, order, width)
    writer, written = unique_writer(dest, mask, width)
    dropped = torch.sum(m, dtype=I32) - torch.sum(written, dtype=I32)
    return writer.to(I32), written, dropped


def compact_rows(mask: torch.Tensor, width: int):
    """:func:`compact_slots` of every row of ``mask`` [..., N]:
    ``(writer [..., width], written [..., width], dropped [...])``."""
    lead = mask.shape[:-1]
    wr, wn, dr = torch.func.vmap(lambda m: compact_slots(m, width))(
        mask.reshape((-1, mask.shape[-1])))
    return (wr.reshape(lead + (width,)), wn.reshape(lead + (width,)),
            dr.reshape(lead))


def gather_lanes(template, src, writer: torch.Tensor,
                 written: torch.Tensor):
    """``out[..., i] = src[..., writer[..., i]]`` where ``written``, else
    ``template[i]``, leaf-wise over matching NamedTuples of tensors (lanes
    on the axis of ``writer``'s last; trailing axes ride along, leading
    ones broadcast)."""
    ax = writer.dim() - 1

    def pick(t, s):
        extra = (1,) * (s.dim() - ax - 1)
        idx = writer.long().reshape(writer.shape + extra)
        got = torch.take_along_dim(s, idx, dim=ax)
        return torch.where(written.reshape(written.shape + extra), got, t)

    return type(template)(*(pick(t, s) for t, s in zip(template, src)))


def racks_to_rows(x: torch.Tensor) -> torch.Tensor:
    """[R, S, L, ...] -> [S, R*L, ...]: per-subround rows over all racks'
    lanes (rack-major within a row)."""
    r, s_ax, lanes = x.shape[:3]
    return x.transpose(0, 1).reshape((s_ax, r * lanes) + x.shape[3:])


def exchange_to_spine(reqs, mask: torch.Tensor, template):
    """Compact every rack's masked lanes into the spine ingress.

    ``reqs``: a packet batch with leaves [R, S, L, ...]; ``mask``
    bool[R, S, L]; ``template``: the empty spine row, leaves [W, ...].
    Returns ``(spine [S, W, ...], writer [S, W], written [S, W], dropped
    int32[])``."""
    rows = type(reqs)(*(racks_to_rows(a) for a in reqs))
    width = template[0].shape[0]
    writer, written, dropped = compact_rows(racks_to_rows(mask), width)
    spine = gather_lanes(template, rows, writer, written)
    return spine, writer, written, torch.sum(dropped, dtype=I32)


def exchange_to_racks(spine_batch, fwd_mask: torch.Tensor,
                      home: torch.Tensor, n_racks: int, template):
    """Scatter the spine's masked egress lanes to their owning racks.

    ``spine_batch`` leaves [S, W, ...]; ``fwd_mask`` / ``home``
    bool/int32[S, W]; ``template`` the empty per-rack row, leaves
    [Wf, ...].  Rack r's lanes (``fwd_mask & (home == r)``) compact into
    its forward rows, per subround.  Returns ``(rack_batches [R, S, Wf,
    ...], dropped int32[])``."""
    width = template[0].shape[0]
    racks = source_racks(n_racks, 3, fwd_mask.device)
    masks = fwd_mask[None] & (home[None] == racks)          # [R, S, W]
    writer, written, dropped = compact_rows(masks, width)   # [R, S, Wf]
    src = type(spine_batch)(*(a[None] for a in spine_batch))
    return (gather_lanes(template, src, writer, written),
            torch.sum(dropped, dtype=I32))
