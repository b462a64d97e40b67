"""Phase 1: tau-boundary control work (paper §3.3) + SFC signalling.

Torch port of `repro.sim.phases.control`. Pops at most one to-be-resumed
flow per (port, queue) per tau from the resume ring (disabled by the
`resume_limit=False` ablation), clears its pause bit, decrements the
upstream counting Bloom filter, and rotates the filter pipeline
counts -> in-flight snapshot -> applied snapshot every tau. The resume gate
compares occupancy against `ctx.th` from the fused switch step.

With `proto.source_signal` (SFC) every tau each congested egress port
launches a pause signal straight back to the sending NIC of each flow
queued there, riding the `sfc_ring` delay line for `hop * prop_ticks + 1`
ticks.
"""
from __future__ import annotations

import torch

from ...core import bloom
from .ctx import (I32, PhaseEnv, StepCtx, hop_of_port, lane_sum,
                  scatter_max, scatter_set)


def control(env: PhaseEnv, st, ops, topo, ctx: StepCtx) -> StepCtx:
    pc = env.cfg.proto
    F, PLCAP = env.F, env.PLCAP
    ar = env.ar

    is_tau = (ctx.t % env.TAU) == 0
    bloom_counts, bloom_mid, bloom_rx = (st.bloom_counts, st.bloom_mid,
                                         st.bloom_rx)
    pl_head, pl = st.pl_head, st.pl
    f_paused = st.f_paused
    if pc.backpressure:
        pending = st.pl_tail > pl_head
        below = ctx.occ < ctx.th[:, None]
        if pc.resume_limit:
            do_pop = pending & below & is_tau   # <=1 per queue per tau
        else:
            do_pop = pending & below            # ablation: no throttling
        cand = torch.gather(st.pl, 2,
                            (pl_head % PLCAP).long()[..., None])[..., 0]
        cand_f = cand.clamp(min=0)
        cand_hop = hop_of_port(ops.routes, cand_f, ar.p[:, None])  # (P,Q)
        valid = (do_pop & (cand >= 0)
                 & (st.f_q[cand_f, cand_hop] == ar.q[None, :])
                 & st.f_paused[cand_f, cand_hop]
                 & (st.f_cnt[cand_f, cand_hop] > 0))
        pl_head = pl_head + do_pop.to(I32)
        # unpause (invalid lanes land in the dump row)
        flat_f = torch.where(valid, cand_f, F).reshape(-1)
        flat_hop = cand_hop.reshape(-1)
        f_paused = scatter_set(f_paused, (flat_f, flat_hop), False)
        up_port = ops.routes[cand_f.reshape(-1),
                             (flat_hop - 1).clamp(min=0)]
        bloom_counts = bloom.add_batch(
            bloom_counts, up_port.clamp(min=0), ops.fpos[cand_f.reshape(-1)],
            -valid.reshape(-1).to(I32))
        # rotate the filter pipeline every tau (models propagation delay)
        bloom_rx = torch.where(is_tau, bloom_mid, bloom_rx)
        bloom_mid = torch.where(is_tau, bloom.snapshot(bloom_counts),
                                bloom_mid)

    # SFC: near-source pause signalling (see module docstring)
    sfc_ring = st.sfc_ring
    n_sfc = torch.zeros(env.lead, dtype=I32, device=env.device)
    if pc.source_signal:
        H = env.H
        ports = ops.routes.clamp(min=0)                          # (F, H)
        pocc = ctx.port_occ[ports]                               # (F, H)
        congested = (is_tau & (st.f_cnt > 0) & (ops.routes >= 0)
                     & (pocc > pc.sfc_threshold))                # (F, H)
        dur = pocc.clamp(1, pc.sfc_max_pause)                    # (F, H)
        # upstream wire distance: hop h's switch is h links from the NIC,
        # at the link delay of the flow's lane
        delay = (torch.arange(H, dtype=I32, device=env.device)
                 * topo.prop_ticks.reshape(-1, 1, 1) + 1)       # (K|1, 1, H)
        slot = (ctx.t + delay) % env.RING
        lane_fh = (env.lanes, -1, H)
        sfc_ring = scatter_max(sfc_ring, (slot, ar.f.view(lane_fh[:2] + (1,))),
                               dur.view(lane_fh), congested.view(lane_fh))
        n_sfc = lane_sum(env, congested)

    return ctx._replace(bloom_counts=bloom_counts, bloom_mid=bloom_mid,
                        bloom_rx=bloom_rx, pl=pl, pl_head=pl_head,
                        f_paused=f_paused, sfc_ring=sfc_ring, n_sfc=n_sfc)
