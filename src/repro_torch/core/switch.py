"""The OrbitCache switch data plane, one step (port of
``repro.core.switch``, paper §3.3, Fig. 4).

``switch_step`` processes one batch of ingress packets followed by one
orbit serving round:

  R-REQ  hit+valid  -> enqueue metadata, drop packet        (Fig. 4a)
         hit+invalid-> forward to server (pending write)    (§3.3)
         hit+full   -> overflow++ and forward to server
         miss       -> forward to server
  W-REQ  hit        -> invalidate, FLAG=1, forward          (Fig. 4c)
         miss       -> forward
  R-REP  (from server) -> forward to client
  W-REP  FLAG&hit   -> validate + clone: install orbit line,
                        original to client                   (Fig. 4d)
  F-REP  FLAG&hit   -> validate + install orbit line, absorb
  CRN-REQ           -> bypass cache logic, forward to server (§3.6)

The work is :func:`repro_torch.core.pipeline.switch_pipeline`: on a CUDA
tensor, one launch of the hand-written ``subround`` kernel, then the
step's value-byte install.
"""
from __future__ import annotations

import torch

from .pipeline import StepOutput, StepStats, switch_pipeline
from .types import (  # noqa: F401  (re-exported for tests and examples)
    OP_CRN_REQ, OP_F_REP, OP_F_REQ, OP_R_REP, OP_R_REQ, OP_W_REP, OP_W_REQ,
    ROUTE_CLIENT, ROUTE_DROP, ROUTE_SERVER, PacketBatch, SwitchState,
)

__all__ = ["StepOutput", "StepStats", "switch_step"]


def switch_step(sw: SwitchState, pkts: PacketBatch,
                recirc_packets: torch.Tensor, max_serves: int,
                ) -> tuple[SwitchState, StepOutput]:
    """Process one ingress batch + one orbit serving round."""
    return switch_pipeline(sw, pkts, recirc_packets, max_serves)
