"""Phase 5: feedback consumption + congestion-control law updates.

Torch port of `repro.sim.phases.feedback`. Drains this tick's row of the
delayed feedback rings (ACKs, ECN echoes, HPCC max-path-utilization or
FairQ bottleneck flow count, retransmit credits) and applies the configured
end-host law: DCTCP's alpha-EWMA window cut, HPCC's reference-window rule,
DCQCN's rate decrease / additive-increase timers, or FairQ's fair-share
rate chase. Under `proto.source_signal` (SFC) it also lands this tick's
row of the `sfc_ring` pause-signal delay line into `sfc_until`.

`cc_laws` keeps the reference's float32 operations in the reference's
order -- with the fused multiply-adds, reciprocal multiplies and denormal
flushes its compiled code performs (see `ctx.fma`) -- so the float leaves
stay bit-identical to the JAX run.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .ctx import F32, PhaseEnv, StepCtx, fma, ftz, recip, take_row


class CCVars(NamedTuple):
    """The (F,)-shaped end-host congestion-control state `cc_laws`
    evolves; the engine replays it over a skipped quiescent tail."""
    cwnd: torch.Tensor
    cwnd_ref: torch.Tensor
    rate: torch.Tensor
    rate_target: torch.Tensor
    alpha: torch.Tensor
    ack_seen: torch.Tensor
    mark_seen: torch.Tensor
    cc_timer: torch.Tensor
    since_dec: torch.Tensor

    @classmethod
    def of_state(cls, st) -> "CCVars":
        return cls(cwnd=st.cwnd, cwnd_ref=st.cwnd_ref, rate=st.rate,
                   rate_target=st.rate_target, alpha=st.alpha,
                   ack_seen=st.ack_seen, mark_seen=st.mark_seen,
                   cc_timer=st.cc_timer, since_dec=st.since_dec)


def cc_laws(env: PhaseEnv, v: CCVars, acks_now, marks_now, u_now) -> CCVars:
    """One tick of the configured congestion-control law: the live
    `feedback` phase calls it with this tick's drained feedback rows, the
    engine's quiescent-tail replay with zeros."""
    pc, tm = env.cfg.proto, env.cfg.timing
    cwnd, cwnd_ref, alpha = v.cwnd, v.cwnd_ref, v.alpha
    ack_seen = v.ack_seen + acks_now
    mark_seen = v.mark_seen + marks_now
    cc_timer = v.cc_timer - 1
    rate, rate_target, since_dec = v.rate, v.rate_target, v.since_dec
    if pc.cc == "dctcp":
        epoch = cc_timer <= 0
        fracm = mark_seen.to(F32) / ack_seen.clamp(min=1)
        alpha = torch.where(epoch,
                            fma(alpha, 1 - pc.dctcp_g, pc.dctcp_g * fracm),
                            alpha)
        cwnd = torch.where(epoch & (mark_seen > 0),
                           cwnd * (1 - alpha / 2), cwnd)
        cwnd = torch.where(epoch & (mark_seen == 0), cwnd + 1.0, cwnd)
        cwnd = cwnd.clamp(1.0, float(pc.window_init))
        ack_seen = torch.where(epoch, 0, ack_seen)
        mark_seen = torch.where(epoch, 0, mark_seen)
        cc_timer = torch.where(epoch, tm.e2e_rtt_ticks, cc_timer)
    elif pc.cc == "hpcc":
        has_fb = acks_now > 0
        u_norm = u_now.clamp(min=1e-3) * recip(pc.hpcc_eta)
        w_new = cwnd_ref / u_norm + pc.hpcc_wai
        cwnd = torch.where(has_fb, w_new.clamp(1.0, float(pc.window_init)),
                           cwnd)
        epoch = cc_timer <= 0
        cwnd_ref = torch.where(epoch, cwnd, cwnd_ref)
        cc_timer = torch.where(epoch, tm.e2e_rtt_ticks, cc_timer)
    elif pc.cc == "dcqcn":
        epoch = cc_timer <= 0
        congested = mark_seen > 0
        rate_target = torch.where(epoch & congested, rate, rate_target)
        rate = torch.where(epoch & congested, rate * (1 - alpha / 2), rate)
        alpha = torch.where(
            epoch,
            torch.where(congested,
                        fma(alpha, 1 - pc.dcqcn_alpha_g, pc.dcqcn_alpha_g),
                        ftz((1 - pc.dcqcn_alpha_g) * alpha)),
            alpha)
        since_dec = torch.where(epoch & congested, 0, since_dec + 1)
        inc = since_dec >= pc.dcqcn_timer
        rate = torch.where(inc, (rate + rate_target) / 2, rate)
        rate_target = torch.where(
            inc, (rate_target + pc.dcqcn_rai).clamp(max=1.0), rate_target)
        since_dec = torch.where(inc, 0, since_dec)
        rate = rate.clamp(1e-3, 1.0)
        mark_seen = torch.where(epoch, 0, mark_seen)
        ack_seen = torch.where(epoch, 0, ack_seen)
        cc_timer = torch.where(epoch, tm.e2e_rtt_ticks, cc_timer)
    elif pc.cc == "fairq":
        # u_now = max active-flow count over the path's links; the fair
        # share there is 1/n. Decreases take effect immediately, increases
        # chase the share with gain fairq_g; with zero feedback every op is
        # the identity.
        has_fb = acks_now > 0
        share = torch.reciprocal(u_now.clamp(min=1.0)).clamp(
            pc.fairq_rate_min, 1.0)
        rate = torch.where(has_fb,
                           torch.where(share < rate, share,
                                       fma(share - rate, pc.fairq_g, rate)),
                           rate)
        rate = rate.clamp(pc.fairq_rate_min, 1.0)

    return CCVars(cwnd=cwnd, cwnd_ref=cwnd_ref, rate=rate,
                  rate_target=rate_target, alpha=alpha, ack_seen=ack_seen,
                  mark_seen=mark_seen, cc_timer=cc_timer,
                  since_dec=since_dec)


def feedback(env: PhaseEnv, st, ops, topo, ctx: StepCtx) -> StepCtx:
    pc = env.cfg.proto
    t = ctx.t

    row = t % env.RING
    rows = row.view(1).long()
    ack_ring, mark_ring, u_ring = ctx.ack_ring, ctx.mark_ring, ctx.u_ring
    acks_now = take_row(ack_ring, row)
    marks_now = take_row(mark_ring, row)
    u_now = take_row(u_ring, row)
    ack_ring = ack_ring.index_fill(0, rows, 0)
    mark_ring = mark_ring.index_fill(0, rows, 0)
    u_ring = u_ring.index_fill(0, rows, 0.0)
    acked = st.acked + acks_now
    rrow = t % env.RRING
    retx_ring = ctx.retx_ring
    retx_now = take_row(retx_ring, rrow)
    retx_ring = retx_ring.index_fill(0, rrow.view(1).long(), 0)
    rem_src = ctx.rem_src + retx_now
    sent = ctx.sent - retx_now

    v = cc_laws(env, CCVars.of_state(st), acks_now, marks_now, u_now)

    # SFC: land this tick's pause signals at the sources (max-combine)
    sfc_ring, sfc_until = ctx.sfc_ring, st.sfc_until
    if pc.source_signal:
        sig = take_row(sfc_ring, row)
        sfc_ring = sfc_ring.index_fill(0, rows, 0)
        sfc_until = torch.where(sig > 0, torch.maximum(sfc_until, t + sig),
                                sfc_until)

    return ctx._replace(ack_ring=ack_ring, mark_ring=mark_ring,
                        u_ring=u_ring, retx_ring=retx_ring, acked=acked,
                        rem_src=rem_src, sent=sent, cwnd=v.cwnd,
                        cwnd_ref=v.cwnd_ref, alpha=v.alpha,
                        ack_seen=v.ack_seen, mark_seen=v.mark_seen,
                        cc_timer=v.cc_timer, rate=v.rate,
                        rate_target=v.rate_target, since_dec=v.since_dec,
                        sfc_ring=sfc_ring, sfc_until=sfc_until)
