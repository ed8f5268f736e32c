"""Plain PyTorch version of the fused subround op.

A term-for-term transliteration of ``repro.kernels.subround.ref``: the
oracle the CUDA kernel is held to bit for bit, and the CPU path.
"""
from __future__ import annotations

import torch

I32 = torch.int32


def _first_true(m: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 where none), like argmax."""
    return torch.argmax(m.to(torch.uint8), dim=dim)


def _last_true(m: torch.Tensor) -> torch.Tensor:
    """Per column of bool[B, N]: the last True row (0 where none)."""
    lanes = torch.arange(m.shape[0], device=m.device)[:, None]
    return torch.argmax(torch.where(m, lanes, -1), dim=0)


def _match_admission(hkey, table_hkeys, occupied, valid, want_mask,
                     qlen, rear, queue_size: int):
    """Fused lookup + admission slice of the subround oracle.

    Returns (cidx [B], hit [B], valid_hit [B], pop [C], accepted [B],
    overflow [B], new_counts [C], writer [C*S], written [C*S]).
    """
    c = table_hkeys.shape[0]
    s = queue_size
    dev = hkey.device

    eq = torch.all(hkey[:, None, :] == table_hkeys[None, :, :], dim=-1)
    eq = eq & (occupied[None, :] > 0)
    hit = torch.any(eq, dim=1)
    cidx = _first_true(eq, 1)
    safe = torch.where(hit, cidx, 0)
    entry_valid = (valid[safe] > 0) & hit
    pop = torch.sum(eq & (want_mask[:, None] > 0), dim=0, dtype=I32)

    want = (want_mask > 0) & hit & entry_valid
    onehot = (safe[:, None] == torch.arange(c, device=dev)[None, :]) \
        & want[:, None]
    oh = onehot.to(I32)
    prior = torch.cumsum(oh, dim=0) - oh   # exclusive
    offset = torch.gather(prior, 1, safe[:, None])[:, 0]
    free = s - qlen
    accepted = want & (offset < free[safe])
    overflow = want & ~accepted
    new_counts = torch.sum(onehot & accepted[:, None], dim=0, dtype=I32)

    slot = (rear[safe] + offset) % s
    flat = safe * s + slot
    woh = accepted[:, None] & (flat[:, None]
                               == torch.arange(c * s, device=dev)[None, :])
    writer = _first_true(woh, 0)
    written = torch.any(woh, dim=0)

    return (torch.where(hit, cidx, -1).to(I32), hit.to(I32),
            entry_valid.to(I32), pop, accepted, overflow, new_counts,
            writer, written)


def subround_ref(
    hkey, want, wreq, inst, frag, nfrags, kidx, vlen, client, seq, port, ts,
    table_hkeys, occupied, st_valid, st_version,
    rt_client, rt_seq, rt_port, rt_ts, rt_acked, rt_kidx, qlen, front, rear,
    ob_live, ob_kidx, ob_version, ob_vlen, ob_frags,
    budget,
    *, queue_size: int, max_frags: int, max_serves: int,
):
    """The whole per-subround switch pass; returns the 32 tensors of
    ``ops.SubroundOuts`` (same order)."""
    c = table_hkeys.shape[0]
    s, f, j = queue_size, max_frags, max_serves
    dev = hkey.device
    budget = torch.as_tensor(budget, dtype=I32, device=dev).reshape(())

    cidx_m, khit, kvhit, pop, accepted, overflow, new_counts, writer, \
        written = _match_admission(hkey, table_hkeys, occupied, st_valid,
                                   want, qlen, rear, s)
    hit = khit > 0
    entry_valid = kvhit > 0
    safe = torch.where(hit, cidx_m, 0).long()

    # ---- request-table metadata apply -------------------------------------
    put = lambda arr, src: torch.where(written, src[writer], arr)
    rt_client2 = put(rt_client, client)
    rt_seq2 = put(rt_seq, seq)
    rt_port2 = put(rt_port, port)
    rt_ts2 = put(rt_ts, ts)
    rt_acked2 = put(rt_acked, torch.zeros_like(seq))
    rt_kidx2 = put(rt_kidx, kidx)
    qlen2 = qlen + new_counts
    rear2 = (rear + new_counts) % s

    # ---- state table: invalidations then validations ----------------------
    w_cached = (wreq > 0) & hit
    install = (inst > 0) & hit
    cols = torch.arange(c, device=dev)[None, :]
    oh_inv = w_cached[:, None] & (safe[:, None] == cols)
    oh_val = install[:, None] & (safe[:, None] == cols)
    bump = torch.sum(oh_inv, dim=0, dtype=I32)
    stv2 = ((st_valid > 0) & ~torch.any(oh_inv, dim=0)) \
        | torch.any(oh_val, dim=0)
    stver2 = st_version + bump

    # ---- orbit-line metadata install (last writer wins) -------------------
    line = safe * f + torch.clamp(frag, 0, f - 1)
    lh = install[:, None] & (line[:, None]
                             == torch.arange(c * f, device=dev)[None, :])
    lwriter = _last_true(lh)
    lwritten = torch.any(lh, dim=0)
    eh = (install & (frag == 0))[:, None] & (safe[:, None] == cols)
    ewriter = _last_true(eh)
    ewritten = torch.any(eh, dim=0)

    inst_version = stver2[safe]   # version AFTER the whole batch's writes
    pick = lambda arr, src: torch.where(lwritten, src[lwriter], arr)
    olive2 = (ob_live > 0) | lwritten
    okidx2 = pick(ob_kidx, kidx)
    over2 = pick(ob_version, inst_version)
    ovlen2 = pick(ob_vlen, vlen)
    ofrags2 = torch.where(ewritten, torch.clamp(nfrags, min=1)[ewriter],
                          ob_frags)

    # ---- serving round ----------------------------------------------------
    ent = torch.repeat_interleave(torch.arange(c, device=dev), f)
    live3 = (occupied[ent] > 0) & stv2[ent] & (over2 == stver2[ent]) & olive2
    n_live = torch.clamp(torch.sum(live3, dtype=I32), min=1)
    per_line = budget // n_live
    live_frag_count = torch.sum(live3.reshape(c, f), dim=1, dtype=I32)
    complete = live_frag_count >= ofrags2
    budget_c = torch.where(complete, per_line, 0).to(I32)

    jj = torch.arange(j, device=dev)[None, :]
    n_serve = torch.minimum(qlen2, budget_c)
    served = jj < n_serve[:, None]
    slot_g = (front[:, None] + jj) % s
    flat_g = torch.arange(c, device=dev)[:, None] * s + slot_g
    g_client = rt_client2[flat_g]
    g_seq = rt_seq2[flat_g]
    g_port = rt_port2[flat_g]
    g_ts = rt_ts2[flat_g]
    g_kidx = rt_kidx2[flat_g]

    n_pop = torch.sum(served, dim=1, dtype=I32)
    qlen3 = qlen2 - n_pop
    front2 = (front + n_pop) % s

    first = torch.arange(c, device=dev) * f
    line_kidx = okidx2[first]
    line_vlen = torch.sum(ovlen2.reshape(c, f), dim=1, dtype=I32)
    line_version = over2[first]

    i32 = lambda x: x.to(I32)
    return (
        i32(hit), i32(entry_valid), i32(accepted), i32(overflow), pop,
        i32(stv2), i32(stver2),
        rt_client2, rt_seq2, rt_port2, rt_ts2, rt_acked2, rt_kidx2,
        i32(qlen3), i32(front2), i32(rear2),
        i32(live3), okidx2, over2, ovlen2, ofrags2,
        i32(lwriter), i32(lwritten),
        i32(served), g_client, g_seq, g_port, g_ts, g_kidx,
        line_kidx, line_vlen, line_version,
    )
