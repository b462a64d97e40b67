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
    """The (C,) trace row of one tick, in `layout` column order.

    `st` is the tick's *pre*-state and `ctx` the StepCtx after phase 5:
    snapshot channels read the values the emit row and the next state are
    assembled from; transition channels count this tick's events."""
    spec = env.cfg.trace
    cols = []
    if spec.switch_occ:
        cols.append(ctx.sw_occ.to(I32))                           # (NSW,)
    if spec.port_pause:
        cols.append(ctx.qpaused.sum(dim=1, dtype=I32))            # (P,)
        cols.append(ctx.pfc_paused.to(I32))                       # (P,)
        cols.append(ctx.n_pauses.view(1).to(I32))
    if spec.flow_state:
        started = (ops.arrival == ctx.t).sum(dtype=I32)
        completed = ((ctx.done >= 0) & (st.done < 0)).sum(dtype=I32)
        # phantom flows (arrival = 2**30) never count as active
        active = ((ops.arrival <= ctx.t) & (ctx.done < 0)).sum(dtype=I32)
        if env.cfg.probe_flow >= 0:
            probe = st.delivered[env.cfg.probe_flow]
        else:
            probe = torch.zeros((), dtype=I32, device=ctx.t.device)
        delivered = ctx.delivered.sum(dtype=I32)
        cols.append(torch.stack([started, completed, active, probe,
                                 delivered]))
    if spec.kernel_path:
        cols.append(torch.where(ctx.can_tx, ctx.sel_q, -1).to(I32))
        cols.append(ctx.can_tx.to(I32))                           # (P,)
    return torch.cat(cols)
