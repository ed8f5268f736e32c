"""The least bytes each hand-written kernel of the port moves per launch,
from a cell's shapes: every input read once and every output written
once, over HBM.  Frozen here from the kernels' argument and output lists
(the arithmetic of the port's ``chip_smoke.py``): 116,356 B for a paper
subround, 3,010,048 B for ``cms`` at 32 x 1,408 x 2,048 and 40,960 B for
``hot_gather`` at 2,048 x 2,048.

The operation bounds lie far below the byte bounds at these shapes
(``subround``'s match, B x C x 5 32-bit operations, takes 3.4 ns at the
float32 rate against 34.7 ns for its bytes), so a kernel's least time is
its bytes over the bandwidth.
"""
from __future__ import annotations

from ..reference.core.controller import ControllerConfig
from ..reference.kernels.cms_ref import DEPTH
from ..reference.kvstore.client import ClientConfig
from ..reference.kvstore.simulator import RackConfig, make_server_config

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
I32 = 4


def lanes(rack: dict) -> tuple[int, int]:
    """``(lanes a window, lanes a subround)`` of a rack's switch ingress:
    client requests, corrections, server replies (padded to the
    subrounds) and controller fetches."""
    cfg = RackConfig(**rack)
    srv = make_server_config(cfg)
    reply = cfg.num_servers * srv.cap_per_window * cfg.max_frags
    reply += (-reply) % cfg.subrounds
    total = (cfg.client_batch + ClientConfig().crn_width + reply
             + cfg.fetch_lanes)
    return total, total // cfg.subrounds


def subround_bytes(rack: dict) -> int:
    """One rack's subround: 30 array arguments and the budget in, 32
    arrays out, at B lanes, C entries, S queue slots, F fragments and J
    serves."""
    cfg = RackConfig(**rack)
    b = lanes(rack)[1]
    c, s, f, j = (cfg.cache_entries, cfg.queue_size, cfg.max_frags,
                  cfg.max_serves)
    args = b * 4 + 11 * b + c * 4 + 3 * c + 6 * c * s + 3 * c + 4 * c * f + c
    outs = (4 * b + 10 * c + 6 * c * s + 6 * c * f + 6 * c * j)
    return I32 * (args + 1 + outs)


def cms_bytes(rack: dict) -> int:
    """One window's count-min launch: the window's key columns ``[B, 5]``,
    the servers' masks ``[N, B]``, their sketches ``[N, 5, W]`` in and
    out and the estimates ``[N, B]``."""
    cfg = RackConfig(**rack)
    srv = make_server_config(cfg)
    b, n, w = lanes(rack)[0], cfg.num_servers, srv.cms_width
    return I32 * (b * DEPTH + n * b + 2 * n * DEPTH * w + n * b)


def hot_gather_calls(rack: dict) -> list[tuple[int, int, int]]:
    """The controller's three calls a period, ``(ids, hot ids, row
    width)``: cached keys against the reports, the reports against
    themselves, the reports against the cached keys."""
    cfg = RackConfig(**rack)
    cap = cfg.cache_entries
    nr = cfg.num_servers * ControllerConfig().k_report
    return [(cap, nr, 1), (nr, nr, 1), (nr, cap, 1)]


def hot_gather_bytes(b: int, c: int, d: int) -> int:
    """One call: ids, hot ids and hits of 4 bytes, int32 rows in and out."""
    return I32 * (b + c + b) + I32 * (c * d + b * d)
