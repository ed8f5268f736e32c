"""NoCache: plain L2/L3 forwarding, no cache logic (port of
``repro.baselines.nocache``)."""
from __future__ import annotations

import torch

from repro_torch.core.types import (
    OP_CRN_REQ, OP_F_REQ, OP_R_REP, OP_R_REQ, OP_W_REP, OP_W_REQ,
    ROUTE_CLIENT, ROUTE_DROP, ROUTE_SERVER, PacketBatch,
)


def nocache_step(state, pkts: PacketBatch):
    """Route requests to servers and replies to clients: ``(state, route,
    flag)``.  ``state`` (the empty policy ``()``) is unused."""
    op, valid = pkts.op, pkts.valid
    to_server = valid & ((op == OP_R_REQ) | (op == OP_W_REQ)
                         | (op == OP_CRN_REQ) | (op == OP_F_REQ))
    to_client = valid & ((op == OP_R_REP) | (op == OP_W_REP))
    route = torch.full_like(op, ROUTE_DROP)
    route = torch.where(to_server, ROUTE_SERVER, route)
    route = torch.where(to_client, ROUTE_CLIENT, route)
    return state, route, pkts.flag
