"""Tick-synchronous, vectorized packet-level network simulator (torch port
of `repro.sim.engine`).

One step advances the whole network by one tick: every egress port
transmits at most one MTU packet, packets propagate on "wires" with a fixed
tick delay, and switches run the configured protocol. The per-tick work is
the phase pipeline under `repro_torch.sim.phases` (derive -> control ->
switch_tx -> nic_tx -> arrivals -> feedback -> stats); the switch decision
inside `derive` is the hand-written CUDA kernel on the card and its plain
torch version on the CPU.

The runner is active-horizon aware, like the reference: it steps in
`DEFAULT_SEGMENT`-tick segments and, after each segment, reads the
`quiescent` predicate back to the host (the only host synchronisation of
a segment). Once nothing can change but the closed-form leaves, the rest of
the horizon is rebuilt by `_finish_tail`, bit-identically to stepping it;
`early_exit=False` steps every tick. Ticks run as a Python loop of eager
torch operations on the operands' device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..core import bloom
from ..core.flow_table import FlowTableParams, buckets_of
from . import phases
from .config import SimConfig
from .phases import BIG, I32  # noqa: F401  (re-export for callers/tests)
from .topology import TopoDims, Topology, pack_topo
from .trace import EMIT_BASE
from .trace import layout as trace_layout
from .workload import PHANTOM_ARRIVAL  # noqa: F401  (re-export)

F32 = torch.float32

# Ticks per segment of the active-horizon runner: the quiescence check
# runs once per segment, so a run overshoots the true quiescent point by
# < one segment.
DEFAULT_SEGMENT = 512


class FlowOperands(NamedTuple):
    """Per-flow metadata the step reads, as tensors on one device.

    Shapes: (F,) / (F, MAX_HOPS) / (F, S)."""
    routes: torch.Tensor      # (F, H) egress port per hop, -1 padded
    src: torch.Tensor         # (F,) source server
    dst: torch.Tensor         # (F,) destination server
    size: torch.Tensor        # (F,) flow size in packets
    arrival: torch.Tensor     # (F,) arrival tick (PHANTOM_ARRIVAL = never)
    fid: torch.Tensor         # (F,) 32-bit flow id
    fpos: torch.Tensor        # (F, S) Bloom-filter bit positions
    fbucket: torch.Tensor     # (F,) flow-table bucket
    hops: torch.Tensor        # (F,) route hop count (transmissions per pkt)


def pack_flows(flows, cfg: SimConfig, device="cuda") -> FlowOperands:
    """The operand bundle for a FlowSet under `cfg`, on `device`. Hashes
    are computed on the host and moved once."""
    dev = resolve_device(device)
    bparams = bloom.BloomParams(cfg.bloom_stages, cfg.bloom_stage_bits)
    ftp = FlowTableParams(cfg.ft_buckets, cfg.ft_bucket_size)
    routes = np.asarray(flows.routes, np.int32)
    fid = torch.from_numpy(np.asarray(flows.fid, np.int32))
    hops = (routes >= 0).sum(1).astype(np.int32)

    def on(a, dtype=np.int32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    return FlowOperands(
        routes=on(routes), src=on(flows.src), dst=on(flows.dst),
        size=on(flows.size_pkts), arrival=on(flows.arrival_tick),
        fid=fid.to(dev), fpos=bloom.positions(fid, bparams).to(dev),
        fbucket=buckets_of(fid, ftp).to(dev), hops=on(hops))


class SimState(NamedTuple):
    t: torch.Tensor
    # flow / source state
    rem_src: torch.Tensor      # (F,) pkts not yet transmitted by the NIC
    sent: torch.Tensor         # (F,)
    acked: torch.Tensor        # (F,)
    delivered: torch.Tensor    # (F,)
    done: torch.Tensor         # (F,) completion tick or -1
    cwnd: torch.Tensor         # (F,) f32
    cwnd_ref: torch.Tensor     # (F,) f32 (HPCC reference window)
    rate: torch.Tensor         # (F,) f32 pkts/tick (DCQCN)
    rate_target: torch.Tensor  # (F,) f32
    tokens: torch.Tensor       # (F,) f32
    alpha: torch.Tensor        # (F,) f32
    ack_seen: torch.Tensor     # (F,) acks in current epoch
    mark_seen: torch.Tensor    # (F,)
    cc_timer: torch.Tensor     # (F,) epoch countdown
    since_dec: torch.Tensor    # (F,) ticks since last rate decrease
    # queues
    qbuf: torch.Tensor         # (P, Q, CAP) packed entry = f*2+mark, -1 empty
    qhead: torch.Tensor        # (P, Q)
    qtail: torch.Tensor        # (P, Q)
    qptr: torch.Tensor         # (P,) DRR pointer
    qsrf: torch.Tensor         # (P, Q) SRF priority key
    # per-flow per-hop switch state (the flow hash table contents)
    f_q: torch.Tensor          # (F, H) assigned queue or -1
    f_cnt: torch.Tensor        # (F, H) packets queued at that hop
    f_paused: torch.Tensor     # (F, H) bool
    # dest-keyed assignment (BFC+DestFQ)
    d_q: torch.Tensor          # (P, NDST)
    d_cnt: torch.Tensor        # (P, NDST)
    # backpressure signalling
    bloom_counts: torch.Tensor  # (P, S, B) counting filter (at downstream)
    bloom_mid: torch.Tensor     # (P, S, B) bool snapshot in flight
    bloom_rx: torch.Tensor      # (P, S, B) bool snapshot applied at upstream
    pl: torch.Tensor            # (P, Q, PLCAP) to-be-resumed flow ring
    pl_head: torch.Tensor       # (P, Q)
    pl_tail: torch.Tensor       # (P, Q)
    # PFC
    ing_occ: torch.Tensor       # (P,) pkts at downstream that arrived via port
    pfc_paused: torch.Tensor    # (P,) bool
    # links (rings wrap at the fabric's prop_ticks <= PROP_MAX)
    wire_f: torch.Tensor        # (P, PROP_MAX) packed entries in flight
    wire_hop: torch.Tensor      # (P, PROP_MAX)
    tx_ewma: torch.Tensor       # (P,) f32 utilization estimate
    # feedback rings
    ack_ring: torch.Tensor      # (RING, F) i32
    mark_ring: torch.Tensor     # (RING, F) i32
    u_ring: torch.Tensor        # (RING, F) f32
    retx_ring: torch.Tensor     # (RRING, F) i32 (delayed retransmit credits)
    # SFC source signalling (inert zeros unless proto.source_signal)
    sfc_ring: torch.Tensor      # (RING, F) i32 in-flight pause signals
    sfc_until: torch.Tensor     # (F,) source paused until this tick
    # NIC scheduling
    nic_ptr: torch.Tensor       # (NSRV,)
    # flow hash table occupancy model
    bucket_cnt: torch.Tensor    # (NSW, NBUCKETS)
    # statistics accumulators
    stat_drops: torch.Tensor
    stat_collisions: torch.Tensor   # allocations that had to share a queue
    stat_allocs: torch.Tensor
    stat_overflow: torch.Tensor     # hash-table bucket overflows
    stat_pauses: torch.Tensor       # pause events sent
    stat_pfc_ticks: torch.Tensor    # (link,tick) pairs paused by PFC
    occ_hist: torch.Tensor          # (BINS,) switch-occupancy histogram
    flows_hist: torch.Tensor        # (FBINS,) active-flows-per-port histogram
    qlen_hist: torch.Tensor         # (BINS,) physical queue length histogram


def make_step(dims: TopoDims, cfg: SimConfig, n_flows: int, device):
    """Build (env, init_state, step) for one simulation shape on `device`.

    `step(st, flow_ops, topo_ops) -> (next_state, emit_row)` runs the seven
    phases in order; every operand must live on `device`."""
    pc, tm = cfg.proto, cfg.timing
    env = phases.make_env(dims, cfg, n_flows, device)
    dev = env.device
    P, NSRV, NSW, PROP = env.P, env.NSRV, env.NSW, env.PROP_MAX
    Q, CAP, PLCAP, S = env.Q, env.CAP, env.PLCAP, env.S
    F, H, RING, RRING = env.F, env.H, env.RING, env.RRING
    B = env.bparams.stage_bits

    def full(shape, value, dtype=I32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def init_state() -> SimState:
        def z(shape):
            return full(shape, 0)
        return SimState(
            t=full((), 0),
            rem_src=z((F,)), sent=z((F,)), acked=z((F,)), delivered=z((F,)),
            done=full((F,), -1),
            cwnd=full((F,), pc.window_init, F32),
            cwnd_ref=full((F,), pc.window_init, F32),
            rate=full((F,), 1.0, F32), rate_target=full((F,), 1.0, F32),
            tokens=full((F,), 1.0, F32), alpha=full((F,), 0.0, F32),
            ack_seen=z((F,)), mark_seen=z((F,)),
            cc_timer=full((F,), tm.e2e_rtt_ticks),
            since_dec=z((F,)),
            qbuf=full((P, Q, CAP), -1),
            qhead=z((P, Q)), qtail=z((P, Q)), qptr=z((P,)),
            qsrf=full((P, Q), BIG),
            f_q=full((F, H), -1), f_cnt=z((F, H)),
            f_paused=full((F, H), False, torch.bool),
            d_q=full((P, NSRV), -1), d_cnt=z((P, NSRV)),
            bloom_counts=bloom.empty_counts(env.bparams, P, device=dev),
            bloom_mid=full((P, S, B), False, torch.bool),
            bloom_rx=full((P, S, B), False, torch.bool),
            pl=full((P, Q, PLCAP), -1), pl_head=z((P, Q)),
            pl_tail=z((P, Q)),
            ing_occ=z((P,)), pfc_paused=full((P,), False, torch.bool),
            wire_f=full((P, PROP), -1),
            wire_hop=z((P, PROP)),
            tx_ewma=full((P,), 0.0, F32),
            ack_ring=z((RING, F)), mark_ring=z((RING, F)),
            u_ring=full((RING, F), 0.0, F32),
            retx_ring=z((RRING, F)),
            sfc_ring=z((RING, F)), sfc_until=z((F,)),
            nic_ptr=z((NSRV,)),
            bucket_cnt=z((NSW, cfg.ft_buckets)),
            stat_drops=z(()), stat_collisions=z(()),
            stat_allocs=z(()), stat_overflow=z(()),
            stat_pauses=z(()), stat_pfc_ticks=z(()),
            occ_hist=z((cfg.occ_bins,)), flows_hist=z((cfg.flows_bins,)),
            qlen_hist=z((cfg.occ_bins,)),
        )

    def step(st: SimState, ops: FlowOperands, topo_ops):
        ctx = phases.derive(env, st, ops, topo_ops)
        ctx = phases.control(env, st, ops, topo_ops, ctx)
        ctx = phases.switch_tx(env, st, ops, topo_ops, ctx)
        ctx = phases.nic_tx(env, st, ops, topo_ops, ctx)
        ctx = phases.arrivals(env, st, ops, topo_ops, ctx)
        ctx = phases.feedback(env, st, ops, topo_ops, ctx)
        return phases.stats(env, st, ops, topo_ops, ctx)

    return env, init_state, step


def quiescent(st: SimState, ops: FlowOperands) -> torch.Tensor:
    """True iff no future tick can change anything but the closed-form
    leaves `_finish_tail` reconstructs: every flow that will ever arrive
    has completed, nothing is in flight on wires or queues, every delayed
    feedback / retransmit credit has landed, and every backpressure signal
    has drained (see `repro.sim.engine.quiescent`). A 0-d bool tensor."""
    flows_done = ((st.done >= 0) | (ops.arrival >= PHANTOM_ARRIVAL)).all()
    net_empty = ((st.wire_f < 0).all()
                 & (st.qtail == st.qhead).all()
                 & (st.f_cnt == 0).all()
                 & (st.ack_ring == 0).all()
                 & (st.mark_ring == 0).all()
                 & (st.u_ring == 0.0).all()
                 & (st.retx_ring == 0).all()
                 & (st.sfc_ring == 0).all())
    signals_clear = ((st.pl_tail == st.pl_head).all()
                     & (st.bloom_counts == 0).all()
                     & ~st.bloom_mid.any() & ~st.bloom_rx.any()
                     & ~st.f_paused.any()
                     & ~st.pfc_paused.any()
                     & (st.ing_occ == 0).all())
    return flows_done & net_empty & signals_clear


def _finish_tail(env, st: SimState, emits, topo_ops, n_ticks: int,
                 active: int, step, flow_ops):
    """Reconstruct ticks [active, n_ticks) of a quiescent network in closed
    form, bit-identical to stepping them.

    Per quiescent tick the full step changes exactly: `t`, the sampled
    histograms (zero bins — `phases.tail_hist`), the emit row (constant),
    and the per-tick decay / congestion-control leaves (`tx_ewma` decay,
    DCQCN/FairQ token refill and the epoch-timer laws), which are replayed
    with zero feedback through the SAME `phases.cc_laws` the live feedback
    phase uses. With tracing on, the constant row comes from evaluating
    `step` once on the quiescent state. Writes `emits[active:]` in place."""
    pc, F = env.cfg.proto, env.F
    zero_i = torch.zeros((F,), dtype=I32, device=env.device)
    zero_f = torch.zeros((F,), dtype=F32, device=env.device)
    tx_ewma, tokens = st.tx_ewma, st.tokens
    v = phases.CCVars.of_state(st)
    for _ in range(n_ticks - active):
        # switch_tx: can_tx is all-False -> pure EWMA decay on every port
        tx_ewma = phases.ftz(tx_ewma * (1 - 1 / 32))
        # nic_tx: the rate-limited NICs keep refilling their token bucket
        if pc.cc in ("dcqcn", "fairq"):
            tokens = (tokens + v.rate).clamp(max=2.0)
        # feedback: drained rings are all zeros
        v = phases.cc_laws(env, v, zero_i, zero_i, zero_f)

    st = phases.tail_hist(env, st, topo_ops, n_ticks)
    if env.cfg.trace.enabled:
        _, row = step(st, flow_ops, topo_ops)
    else:
        row = phases.tail_emit_row(env, st)
    emits[active:] = row
    return st._replace(
        t=torch.full((), n_ticks, dtype=I32, device=env.device),
        tx_ewma=tx_ewma, tokens=tokens, cwnd=v.cwnd, cwnd_ref=v.cwnd_ref,
        rate=v.rate, rate_target=v.rate_target, alpha=v.alpha,
        ack_seen=v.ack_seen, mark_seen=v.mark_seen, cc_timer=v.cc_timer,
        since_dec=v.since_dec)


def simulate(dims: TopoDims, cfg: SimConfig, flow_ops: FlowOperands,
             topo_ops, n_ticks: int, *, segment: int = DEFAULT_SEGMENT,
             early_exit: bool = True):
    """Run `n_ticks` ticks on the operands' device.

    Returns `(state, emits[T, 3 + trace channels], active_ticks)`, all on
    the device but `active_ticks`, the tick the run actually stepped to
    before the closed-form tail took over (= n_ticks when no early exit).
    The segmented runner reads `quiescent` once per `segment` ticks. Runs
    under `torch.inference_mode` (no autograd bookkeeping per op), so the
    returned tensors are inference tensors."""
    with torch.inference_mode():
        return _simulate(dims, cfg, flow_ops, topo_ops, int(n_ticks),
                         segment, early_exit)


def _simulate(dims, cfg, flow_ops, topo_ops, n_ticks, segment, early_exit):
    env, init_state, step = make_step(dims, cfg, flow_ops.arrival.shape[0],
                                      flow_ops.arrival.device)
    emit_w = EMIT_BASE + trace_layout(cfg.trace, dims.n_ports,
                                      dims.n_switches).width
    emits = torch.zeros((n_ticks, emit_w), dtype=I32, device=env.device)
    st = init_state()

    def advance(st, t0, length):
        for t in range(t0, t0 + length):
            st, row = step(st, flow_ops, topo_ops)
            emits[t] = row
        return st, t0 + length

    if not early_exit or n_ticks == 0:
        st, _ = advance(st, 0, n_ticks)
        return st, emits, n_ticks

    # a segment never exceeds the horizon
    seg = min(segment, n_ticks)
    n_full, rem = divmod(n_ticks, seg)
    t = 0
    while t < n_full * seg and not bool(quiescent(st, flow_ops)):
        st, t = advance(st, t, seg)
    if rem and not bool(quiescent(st, flow_ops)):
        # horizon not a segment multiple: run the remainder unless the loop
        # already went quiescent (then the tail covers it)
        st, t = advance(st, t, rem)
    active = t
    st = _finish_tail(env, st, emits, topo_ops, n_ticks, active, step,
                      flow_ops)
    return st, emits, active


def to_numpy(st: SimState) -> SimState:
    """A SimState with every leaf copied to a host numpy array."""
    return SimState(*(leaf.detach().cpu().numpy() for leaf in st))


def run(topo: Topology, flows, cfg: SimConfig, n_ticks: int, *,
        device="cuda", segment: int = DEFAULT_SEGMENT,
        early_exit: bool = True):
    """Run the simulation for `n_ticks` on `device` (the card unless the
    caller passes ``device="cpu"``; a CUDA request without a card raises).
    Returns (final_state, emits) as host numpy, emits of shape
    (T, 3 + trace channels) — like `repro.sim.engine.run`."""
    dev = resolve_device(device)
    st, emits, _ = simulate(
        TopoDims.of(topo), cfg, pack_flows(flows, cfg, dev),
        pack_topo(topo, infinite_buffer=cfg.proto.infinite_buffer,
                  device=dev),
        n_ticks, segment=segment, early_exit=early_exit)
    return to_numpy(st), emits.cpu().numpy()
