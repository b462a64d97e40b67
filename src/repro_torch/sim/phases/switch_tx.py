"""Phase 2: switch egress transmissions (paper §3.2).

Torch port of `repro.sim.phases.switch_tx`. Every unpaused, non-empty
switch egress port dequeues at most one packet per tick: the fused switch
step run by `derive` already picked the queue (DRR rotating pointer or SRF
smallest-remaining-first key); the head packet leaves its ring buffer and
all per-flow / per-dest / hash-table / PFC bookkeeping records the
departure. Flows whose last queued packet departs release their queue and
(if paused) their upstream Bloom-filter bits."""
from __future__ import annotations

import torch

from ...core import bloom
from .ctx import (BIG, I32, F32, PhaseEnv, StepCtx, fma, hop_of_port,
                  scatter_add, scatter_set)


def switch_tx(env: PhaseEnv, st, ops, topo, ctx: StepCtx) -> StepCtx:
    pc = env.cfg.proto
    F, CAP, NDST = env.F, env.CAP, env.NDST
    ar = env.ar
    p_ar = ar.p

    f_paused = ctx.f_paused
    # The kernel reports "no eligible queue" as sel -1; the reference's
    # inline pick degenerates to queue 0 there, so normalise for every
    # downstream gather/scatter.
    can_tx = ctx.kcan_tx
    sel_q = torch.where(can_tx, ctx.ksel_q, 0)
    head = st.qhead[p_ar, sel_q] % CAP
    tx_entry = torch.where(can_tx, st.qbuf[p_ar, sel_q, head], -1)
    tx_f = (tx_entry >> 1).clamp(min=0)
    tx_hop = hop_of_port(ops.routes, tx_f, p_ar)
    qhead = scatter_add(st.qhead, (p_ar, sel_q), can_tx.to(I32))
    if pc.scheduler == "drr":
        qptr = torch.where(can_tx, sel_q + 1, st.qptr)
    else:
        qptr = st.qptr

    # flow count decrement at this hop; detect departures (count -> 0)
    f_cnt = scatter_add(st.f_cnt, (tx_f, tx_hop), -can_tx.to(I32))
    departed = can_tx & (f_cnt[tx_f, tx_hop] == 0)
    dep_f = torch.where(departed, tx_f, F)               # dump-row index
    was_paused = f_paused[tx_f, tx_hop] & departed
    up_of_tx = ops.routes[tx_f, (tx_hop - 1).clamp(min=0)]
    bloom_counts = ctx.bloom_counts
    if pc.backpressure:
        bloom_counts = bloom.add_batch(
            bloom_counts, up_of_tx.clamp(min=0), ops.fpos[tx_f],
            -was_paused.to(I32))
        f_paused = scatter_set(f_paused, (dep_f, tx_hop), False)
    f_q = scatter_set(st.f_q, (dep_f, tx_hop), -1)
    # dest-keyed bookkeeping
    d_cnt, d_q = st.d_cnt, st.d_q
    if pc.queue_key == "dest":
        tx_dst = ops.dst[tx_f]
        d_cnt = scatter_add(d_cnt, (p_ar, tx_dst), -can_tx.to(I32))
        d_gone = can_tx & (d_cnt[p_ar, tx_dst] == 0)
        d_q = scatter_set(d_q, (p_ar, torch.where(d_gone, tx_dst, NDST)),
                          -1, axis=1)
    # PFC ingress accounting (packet left the downstream buffer)
    ing_occ = scatter_add(st.ing_occ, (up_of_tx.clamp(min=0),),
                          -(can_tx & (tx_hop > 0)).to(I32))
    # hash-table departure
    bucket_cnt = scatter_add(
        st.bucket_cnt, (topo.port_switch.clamp(min=0), ops.fbucket[tx_f]),
        -departed.to(I32))
    # reset the SRF key when the queue empties (post-tx occupancy from the
    # fused switch step)
    occ_after = ctx.kocc_after
    qsrf = torch.where(
        (occ_after == 0) & (ar.q[None, :] == sel_q[:, None])
        & can_tx[:, None],
        BIG, st.qsrf)
    tx_ewma = fma(st.tx_ewma, 1 - 1 / 32, can_tx.to(F32) / 32)

    return ctx._replace(can_tx=can_tx, sel_q=sel_q, tx_entry=tx_entry,
                        tx_hop=tx_hop,
                        qhead=qhead, qptr=qptr, qsrf=qsrf, f_cnt=f_cnt,
                        f_q=f_q, f_paused=f_paused, d_cnt=d_cnt, d_q=d_q,
                        ing_occ=ing_occ, bucket_cnt=bucket_cnt,
                        occ_after=occ_after, tx_ewma=tx_ewma,
                        bloom_counts=bloom_counts)
