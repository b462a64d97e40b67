"""Simulator + protocol configuration (torch port of `repro.sim.config`).

One engine runs every scheme in the paper; protocols are compositions of
feature flags, exactly mirroring the paper's ablations (BFC+Stochastic =
BFC pausing with static hash queues, HPCC+SFQ = HPCC with 32 static queues,
BFC-BufferOpt = no resume throttling, ...).

The reference's `ProtoConfig.kernel_impl` knob is not carried over: in the
port the device of the operands chooses the switch-decision path (a CUDA
tensor launches the fused kernel, a CPU tensor runs its plain version).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from .topology import ClosParams
from .trace.spec import TraceSpec


@dataclass(frozen=True)
class TimingParams:
    # 1 tick = 1 KB MTU at 100 Gbps = 80 ns
    prop_ticks: int = 12        # ~1 us link propagation
    hrtt_ticks: int = 25        # 1-hop RTT ~ 2 us (prop up+down + pipeline)
    tau_ticks: int = 12         # pause-frame period = 0.5 * HRTT (paper)
    e2e_rtt_ticks: int = 100    # ~8 us max base RTT  -> BDP = 100 pkts
    rto_ticks: int = 300        # retransmit credit delay after a drop

    @property
    def bdp_pkts(self) -> int:
        return self.e2e_rtt_ticks  # 1 pkt/tick line rate

    @property
    def pause_window(self) -> int:
        return self.hrtt_ticks + self.tau_ticks


@dataclass(frozen=True)
class ProtoConfig:
    name: str = "bfc"
    n_queues: int = 32
    queue_cap: int = 256
    pauselist_cap: int = 256
    dynamic_queues: bool = True     # BFC dynamic assignment; False = static hash
    queue_key: str = "flow"         # 'flow' | 'dest'
    backpressure: bool = True       # per-flow pause/resume via Bloom frames
    resume_limit: bool = True       # <=1 resume per tau per queue (buffer opt)
    scheduler: str = "drr"          # 'drr' | 'srf'
    cc: str = "none"          # 'none'|'fixed'|'dctcp'|'dcqcn'|'hpcc'|'fairq'
    ecn: bool = False
    pfc: bool = False
    # SFC (arXiv 2305.00538): switches signal congestion straight back to
    # the sending NIC, which pauses the flow for the queue's drain time.
    source_signal: bool = False
    sfc_threshold: int = 100        # egress occupancy (pkts) that signals
    sfc_max_pause: int = 256        # cap on one signal's pause (ticks)
    # NIC flow scheduling: 'drr' (deficit round-robin, every realizable
    # scheme) | 'srpt' (omniscient shortest-remaining-first -- the
    # centralized-scheduler oracle, arXiv 1710.02548)
    nic_sched: str = "drr"
    window_init: float = 100.0      # pkts; flows start at line rate (1 BDP)
    infinite_buffer: bool = False
    # DCTCP / DCQCN / HPCC constants (ticks / packets)
    dctcp_g: float = 1.0 / 16
    ecn_kmin: int = 100             # pkts (100 KB)
    ecn_kmax: int = 400
    dcqcn_alpha_g: float = 1.0 / 16
    dcqcn_rai: float = 0.02         # additive increase, pkts/tick
    dcqcn_timer: int = 300
    hpcc_eta: float = 0.95
    hpcc_wai: float = 0.5
    # FairQ (arXiv 2401.04850): rate-based fair allocation
    fairq_g: float = 0.25           # EWMA gain toward the fair share
    fairq_rate_min: float = 1e-3    # pkts/tick floor
    pfc_frac: float = 0.11          # of free buffer


# ---- presets matching the paper's evaluation --------------------------------
BFC = ProtoConfig(name="bfc")
BFC_SRF = replace(BFC, name="bfc_srf", scheduler="srf")
BFC_DEST = replace(BFC, name="bfc_dest", queue_key="dest")
BFC_STOCHASTIC = replace(BFC, name="bfc_stochastic", dynamic_queues=False)
BFC_NO_BUFOPT = replace(BFC, name="bfc_nobufopt", resume_limit=False)
BFC_PFC = replace(BFC, name="bfc_pfc", pfc=True)  # PFC as loss safeguard
PFC_ONLY = ProtoConfig(name="pfc", n_queues=1, dynamic_queues=False,
                       backpressure=False, pfc=True, queue_cap=2048)
DCTCP = ProtoConfig(name="dctcp", n_queues=1, dynamic_queues=False,
                    backpressure=False, cc="dctcp", ecn=True, pfc=True,
                    queue_cap=2048)
DCQCN = ProtoConfig(name="dcqcn", n_queues=1, dynamic_queues=False,
                    backpressure=False, cc="dcqcn", ecn=True, pfc=True,
                    queue_cap=2048)
HPCC = ProtoConfig(name="hpcc", n_queues=1, dynamic_queues=False,
                   backpressure=False, cc="hpcc", pfc=True, queue_cap=2048)
HPCC_SFQ = replace(HPCC, name="hpcc_sfq", n_queues=32, queue_cap=256)
IDEAL_FQ = ProtoConfig(name="ideal_fq", n_queues=64, dynamic_queues=True,
                       backpressure=False, cc="fixed", queue_cap=192,
                       infinite_buffer=True)
IDEAL_SRF = replace(IDEAL_FQ, name="ideal_srf", scheduler="srf")
# ---- post-BFC literature (protocol zoo) -------------------------------------
SFC = ProtoConfig(name="sfc", n_queues=1, dynamic_queues=False,
                  backpressure=False, source_signal=True, pfc=True,
                  queue_cap=2048)
FAIRQ = ProtoConfig(name="fairq", n_queues=1, dynamic_queues=False,
                    backpressure=False, cc="fairq", pfc=True,
                    queue_cap=2048)
# Centralized-scheduler oracle: Ideal-SRF fabric plus an omniscient SRPT
# scheduler at every NIC.
ORACLE = replace(IDEAL_SRF, name="oracle", nic_sched="srpt")

PRESETS = {p.name: p for p in
           [BFC, BFC_SRF, BFC_DEST, BFC_STOCHASTIC, BFC_NO_BUFOPT, BFC_PFC,
            PFC_ONLY, DCTCP, DCQCN, HPCC, HPCC_SFQ, IDEAL_FQ, IDEAL_SRF,
            SFC, FAIRQ, ORACLE]}


@dataclass(frozen=True)
class SimConfig:
    proto: ProtoConfig
    timing: TimingParams = TimingParams()
    clos: ClosParams = ClosParams()
    bloom_stages: int = 4
    bloom_stage_bits: int = 256
    ft_buckets: int = 8192
    ft_bucket_size: int = 4
    stat_every: int = 64
    occ_bins: int = 64
    flows_bins: int = 65
    probe_flow: int = -1            # long-lived flow to trace throughput
    # Opt-in per-tick channel capture (see sim/trace/); the default all-off
    # spec emits the 3 legacy columns only.
    trace: TraceSpec = TraceSpec()
