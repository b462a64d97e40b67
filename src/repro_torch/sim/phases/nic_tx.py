"""Phase 3: NIC transmissions (paper §3.4 source behavior).

Torch port of `repro.sim.phases.nic_tx`. Each server runs deficit
round-robin over its eligible flows (started, has work, not completed, not
paused by the first-hop Bloom snapshot, not PFC paused, not SFC-paused past
`sfc_until`, within its congestion window / rate-limiter budget) and
transmits at most one packet per tick, picked by a per-server packed
segment-min. The centralized-scheduler oracle (`nic_sched == 'srpt'`)
replaces the DRR score with shortest-remaining-first: two chained
segment-mins (min remaining size, then min flow index among the tied)."""
from __future__ import annotations

import torch

from .ctx import (F32, I32, INT32_MAX, PhaseEnv, StepCtx, scatter_add,
                  segment_min)


def nic_tx(env: PhaseEnv, st, ops, topo, ctx: StepCtx) -> StepCtx:
    pc = env.cfg.proto
    F, F_LANE, NSRV = env.F, env.F_LANE, env.NSRV
    ar = env.ar
    win_proto = pc.cc in ("dctcp", "hpcc", "fixed")
    rate_proto = pc.cc in ("dcqcn", "fairq")

    rem_src = ctx.rem_src
    started = ops.arrival <= ctx.t
    avail = started & (rem_src > 0) & (st.done < 0)
    first = ops.routes[:, 0]       # -1 for phantoms wraps, as jnp indexing
    if pc.backpressure:
        got_nic = ctx.bloom_rx[first[:, None], ar.s[None, :],
                               ops.fpos]                # (F, S)
        nic_paused = got_nic.all(dim=-1)
    else:
        nic_paused = torch.zeros((F,), dtype=torch.bool, device=env.device)
    elig_f = avail & ~nic_paused & ~ctx.pfc_paused[first]
    if pc.source_signal:
        elig_f &= ctx.t >= st.sfc_until
    if win_proto:
        elig_f &= (st.sent - st.acked) < st.cwnd.to(I32)
    tokens = st.tokens
    if rate_proto:
        tokens = (tokens + st.rate).clamp(max=2.0)
        elig_f &= tokens >= 1.0
    f_ar = ar.f
    if pc.nic_sched == "srpt":
        # centralized oracle: shortest remaining size first, flow index
        # breaking ties
        remaining = (ops.size - st.delivered).clamp(min=1)
        rem_key = torch.where(elig_f, remaining, INT32_MAX)
        best_rem = segment_min(rem_key, ops.src, NSRV)
        is_best = elig_f & (rem_key == best_rem[ops.src])
        best_f = segment_min(torch.where(is_best, f_ar, INT32_MAX), ops.src,
                             NSRV)
        nic_ptr = st.nic_ptr          # DRR pointer unused under SRPT
    else:
        # per-server DRR over flows (packed segment-min of (score, flow);
        # F_LANE * F fits int32, `ctx.make_env` checks). A server's flows
        # are its lane's, and the pointer is a flow id of that lane (or 0),
        # so the score modulo the lane's flow count is the lane's own.
        score = (f_ar - st.nic_ptr[ops.src]) % F_LANE
        packed_f = torch.where(elig_f, score * F + f_ar, INT32_MAX)
        best_f = segment_min(packed_f, ops.src, NSRV)
        best_f = torch.where(best_f < INT32_MAX, best_f % F, INT32_MAX)
        nic_ptr = None                # resolved after nic_sel below
    nic_can_tx = best_f < INT32_MAX
    nic_sel = torch.where(nic_can_tx, best_f, 0).to(I32)
    rem_src = scatter_add(rem_src, (nic_sel,), -nic_can_tx.to(I32))
    sent = scatter_add(st.sent, (nic_sel,), nic_can_tx.to(I32))
    if rate_proto:
        tokens = scatter_add(tokens, (nic_sel,), -nic_can_tx.to(F32))
    if nic_ptr is None:
        nic_ptr = torch.where(nic_can_tx, nic_sel + 1, st.nic_ptr)
    tx_ewma = scatter_add(ctx.tx_ewma, (ar.srv,), nic_can_tx.to(F32) / 32)

    return ctx._replace(rem_src=rem_src, sent=sent, tokens=tokens,
                        nic_ptr=nic_ptr, tx_ewma=tx_ewma,
                        nic_tx=nic_can_tx, nic_sel=nic_sel)
