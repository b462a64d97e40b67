"""Phase modules of the tick-synchronous simulator step (torch port of
`repro.sim.phases`).

Every phase has the signature

    phase(env: PhaseEnv, st: SimState, ops: FlowOperands,
          topo: TopoOperands, ctx: StepCtx) -> StepCtx

Phase order per tick:
  0. ctx.derive        occupancy, pause bits, the fused switch step
  1. control           tau-boundary resumes + Bloom pipeline rotation
  2. switch_tx         switch egress transmissions (DRR/SRF)
  3. nic_tx            NIC transmissions (per-server DRR over flows)
  4. arrivals          wire propagation, deliveries, enqueues, pauses, drops
  5. feedback          ACK/ECN/INT consumption + congestion-control laws
  6. stats             histograms + next SimState + per-tick emit row
"""
from .ctx import (ArrivalLayout, BIG, I32, PhaseEnv, StepCtx, build_layout,
                  derive, fma, ftz, make_env, pairwise_rank, recip,
                  subset_rank)
from .control import control
from .switch_tx import switch_tx
from .nic_tx import nic_tx
from .arrivals import SORTS_PER_TICK, arrivals
from .feedback import CCVars, cc_laws, feedback
from .stats import stats, tail_emit_row, tail_hist

__all__ = ["ArrivalLayout", "BIG", "CCVars", "I32", "PhaseEnv",
           "SORTS_PER_TICK", "StepCtx", "build_layout", "cc_laws",
           "control", "derive", "feedback", "fma", "ftz", "make_env",
           "nic_tx", "recip",
           "pairwise_rank", "stats", "subset_rank",
           "switch_tx", "tail_emit_row", "tail_hist"]
