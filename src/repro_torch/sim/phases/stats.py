"""Phase 6: statistics + next-state assembly.

Torch port of `repro.sim.phases.stats`. Samples the switch-occupancy /
active-flows-per-port / queue-length histograms every `stat_every` ticks
(phantom ports and switches are masked out by `port_valid` /
`switch_valid`), folds this tick's event counts into the running counters,
and packs the next SimState plus the per-tick emit row (max buffer fill,
PFC-paused ports, probe-flow progress, then any trace channels).

`tail_hist` / `tail_emit_row` are the closed forms of the same sampling
over a *quiescent* suffix of the horizon, used by the engine to rebuild
the skipped drain tail bit-identically to stepping it.

In a batch of lanes every counter, histogram and emit column is per lane
(leading axis ``env.lead``): reductions run over (lanes, n) views of the
lane-contiguous ports, switches and flows."""
from __future__ import annotations

import torch

from ..trace.capture import capture_row
from .ctx import (I32, PhaseEnv, StepCtx, lane_scalar, lane_sum,
                  scatter_add, segment_sum)


def _add_first(x, v):
    """``x.at[..., 0].add(v)`` for a per-lane ``v``."""
    return torch.cat([x[..., :1] + v[..., None], x[..., 1:]], dim=-1)


def _hist_add(env: PhaseEnv, hist, bins, vals):
    """Add `vals` at `bins` (both lane-contiguous) into each lane's row of
    `hist` (``env.lead + (n_bins,)``): the lane is the row of the (lanes, n)
    view, never an offset computed on the bin."""
    if not env.lead:
        return scatter_add(hist, (bins.reshape(-1),), vals.reshape(-1))
    return hist.scatter_add(1, bins.reshape(env.lanes, -1).long(),
                            vals.reshape(env.lanes, -1).to(hist.dtype))


def tail_hist(env: PhaseEnv, st, topo, n_ticks: int):
    """Fold the histogram samples of ticks [st.t, n_ticks) -- all quiescent,
    so every sampled value is zero -- into the running histograms."""
    se = env.cfg.stat_every
    # sample ticks are multiples of stat_every: #multiples in [t, n_ticks)
    n_samp = (n_ticks + (se - 1)) // se - (st.t + (se - 1)) // se
    occ_hist = _add_first(st.occ_hist,
                          n_samp * lane_sum(env, topo.switch_valid))
    flows_hist = _add_first(
        st.flows_hist,
        n_samp * lane_sum(env, ~topo.port_is_nic & topo.port_valid))
    # qlen_hist only counts non-empty queues — a quiescent tail adds none
    return st._replace(occ_hist=occ_hist, flows_hist=flows_hist)


def _probe(env: PhaseEnv, st):
    if env.cfg.probe_flow >= 0:
        return st.delivered.reshape(*env.lead, -1)[..., env.cfg.probe_flow]
    return torch.zeros(env.lead, dtype=I32, device=env.device)


def tail_emit_row(env: PhaseEnv, st):
    """The constant emit row of a quiescent tick: zero buffer fill, zero
    PFC-paused ports, frozen probe-flow progress."""
    zero = torch.zeros(env.lead, dtype=I32, device=env.device)
    return torch.stack([zero, zero, _probe(env, st)], dim=-1)


def stats(env: PhaseEnv, st, ops, topo, ctx: StepCtx):
    """Returns (new_state, emit row)."""
    cfg = env.cfg
    t = ctx.t

    sample = (t % cfg.stat_every) == 0
    occ_bin = (ctx.sw_occ.view(env.lanes, -1) * cfg.occ_bins
               // lane_scalar(topo.occ_ref).clamp(min=1)).clamp(
                   0, cfg.occ_bins - 1)
    occ_hist = _hist_add(env, st.occ_hist, occ_bin,
                         (sample & topo.switch_valid).to(I32))
    # active flows per switch egress port (Fig. 10c)
    active_fh = (ctx.f_cnt > 0) & (ops.routes >= 0)
    per_port = segment_sum(active_fh.to(I32).reshape(-1),
                           ops.routes.clamp(min=0).reshape(-1), env.P)
    fl_bin = per_port.clamp(0, cfg.flows_bins - 1)
    flows_hist = _hist_add(
        env, st.flows_hist, fl_bin,
        (sample & ~topo.port_is_nic & topo.port_valid).to(I32))
    qlen_bin = (ctx.occ_new * cfg.occ_bins // max(env.CAP, 1)).clamp(
        0, cfg.occ_bins - 1)
    qlen_hist = _hist_add(
        env, st.qlen_hist, qlen_bin,
        (sample & (ctx.occ_new.reshape(-1) > 0)).to(I32))

    new_st = type(st)(
        t=t + 1, rem_src=ctx.rem_src, sent=ctx.sent, acked=ctx.acked,
        delivered=ctx.delivered, done=ctx.done, cwnd=ctx.cwnd,
        cwnd_ref=ctx.cwnd_ref, rate=ctx.rate, rate_target=ctx.rate_target,
        tokens=ctx.tokens, alpha=ctx.alpha, ack_seen=ctx.ack_seen,
        mark_seen=ctx.mark_seen, cc_timer=ctx.cc_timer,
        since_dec=ctx.since_dec, qbuf=ctx.qbuf, qhead=ctx.qhead,
        qtail=ctx.qtail, qptr=ctx.qptr, qsrf=ctx.qsrf, f_q=ctx.f_q,
        f_cnt=ctx.f_cnt, f_paused=ctx.f_paused, d_q=ctx.d_q,
        d_cnt=ctx.d_cnt, bloom_counts=ctx.bloom_counts,
        bloom_mid=ctx.bloom_mid, bloom_rx=ctx.bloom_rx, pl=ctx.pl,
        pl_head=ctx.pl_head, pl_tail=ctx.pl_tail, ing_occ=ctx.ing_occ,
        pfc_paused=ctx.pfc_paused, wire_f=ctx.wire_f,
        wire_hop=ctx.wire_hop, tx_ewma=ctx.tx_ewma, ack_ring=ctx.ack_ring,
        mark_ring=ctx.mark_ring, u_ring=ctx.u_ring,
        retx_ring=ctx.retx_ring, sfc_ring=ctx.sfc_ring,
        sfc_until=ctx.sfc_until, nic_ptr=ctx.nic_ptr,
        bucket_cnt=ctx.bucket_cnt,
        stat_drops=st.stat_drops + lane_sum(env, ctx.dropped),
        stat_collisions=st.stat_collisions + lane_sum(env, ctx.collide),
        stat_allocs=st.stat_allocs + lane_sum(env, ctx.needs_alloc),
        stat_overflow=st.stat_overflow + ctx.overflow_ev,
        stat_pauses=st.stat_pauses + ctx.n_pauses + ctx.n_sfc,
        stat_pfc_ticks=st.stat_pfc_ticks + lane_sum(env, ctx.pfc_paused),
        occ_hist=occ_hist, flows_hist=flows_hist, qlen_hist=qlen_hist,
    )
    emit = torch.stack([ctx.sw_occ.view(*env.lead, -1).amax(-1),
                        lane_sum(env, ctx.pfc_paused), _probe(env, st)],
                       dim=-1)
    if cfg.trace.enabled:
        # opt-in trace channels ride the emit row (sim/trace/)
        emit = torch.cat([emit, capture_row(env, st, ops, ctx)], dim=-1)
    return new_st, emit
