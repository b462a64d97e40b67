"""Per-tick channel capture: one int32 row per tick, appended to the emit
row by `phases/stats.py` (torch port of `repro.sim.trace.capture`).

Column order MUST match `trace.spec.layout`. Every value is derived from
`StepCtx` / `SimState` leaves the phases already materialized this tick,
so capture never changes the simulation itself.
"""
from __future__ import annotations

import torch

I32 = torch.int32


def capture_row(env, st, ops, ctx) -> torch.Tensor:
    """The (C,) trace row of one tick, in `layout` column order (one row
    per lane, ``env.lead + (C,)``, in a batch of lanes).

    `st` is the tick's *pre*-state and `ctx` the StepCtx after phase 5:
    snapshot channels read the values the emit row and the next state are
    assembled from; transition channels count this tick's events."""
    spec = env.cfg.trace
    lead = env.lead

    def per_lane(x):                      # lane-contiguous -> (*lead, n)
        return x.reshape(*lead, -1).to(I32)

    def lane_sum(x):
        return x.reshape(*lead, -1).sum(-1, dtype=I32)

    cols = []
    if spec.switch_occ:
        cols.append(per_lane(ctx.sw_occ))                         # (NSW,)
    if spec.port_pause:
        cols.append(per_lane(ctx.qpaused.sum(dim=1, dtype=I32)))  # (P,)
        cols.append(per_lane(ctx.pfc_paused))                     # (P,)
        cols.append(ctx.n_pauses.to(I32)[..., None])
    if spec.flow_state:
        started = lane_sum(ops.arrival == ctx.t)
        completed = lane_sum((ctx.done >= 0) & (st.done < 0))
        # phantom flows (arrival = 2**30) never count as active
        active = lane_sum((ops.arrival <= ctx.t) & (ctx.done < 0))
        if env.cfg.probe_flow >= 0:
            probe = st.delivered.reshape(*lead, -1)[..., env.cfg.probe_flow]
        else:
            probe = torch.zeros(lead, dtype=I32, device=ctx.t.device)
        delivered = lane_sum(ctx.delivered)
        cols.append(torch.stack([started, completed, active, probe,
                                 delivered], dim=-1))
    if spec.kernel_path:
        cols.append(per_lane(torch.where(ctx.can_tx, ctx.sel_q, -1)))
        cols.append(per_lane(ctx.can_tx))                         # (P,)
    return torch.cat(cols, dim=-1)
