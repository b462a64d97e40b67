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
`early_exit=False` steps every tick.

On a CUDA device the ticks run through `TickGraph`: `GRAPH_TICKS` chained
steps are captured once per `simulate` call as one CUDA graph and
replayed, the counterpart of the reference's jitted segment `scan`; the
host no longer issues each of a tick's ~680 launches. On the CPU ticks run
as a Python loop of eager torch operations (`TickLoop`). The eager step
stays reachable through `make_step`.

`simulate_lanes` runs a batch of K simulations (`sim/sweep.py`) as one
larger fabric, the K lanes laid side by side (`phases.ctx`): the state is
the single run's layout over K times the ports, servers, switches and
flows, with per-lane counters, histograms and emit rows, and one lane is
exactly a single run. `to_numpy(st, lanes)` turns a batch's state into the
reference's (K, ...) layout with lane-local ids, once per run.
"""
from __future__ import annotations

from contextlib import nullcontext
from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..core import bloom
from ..core.flow_table import FlowTableParams, buckets_of
from ..kernels.bfc_step import ops as kernel_ops
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
# Ticks per captured CUDA graph (`TickGraph`); divides DEFAULT_SEGMENT, so
# a segment is whole replays.
GRAPH_TICKS = 32


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


def static_cfg(cfg: SimConfig) -> SimConfig:
    """The part of a SimConfig that shapes the step (its protocol and
    timing): `clos` stripped, since the fabric arrives as operands. Cases
    that agree on it run as lanes of one batch (`sweep.run_grid`)."""
    return replace(cfg, clos=None)


def make_step(dims: TopoDims, cfg: SimConfig, n_flows: int, device,
              lanes: int = 1):
    """Build (env, init_state, step) for one simulation shape on `device`:
    `lanes` simulations of `n_flows` flows on fabrics padded to `dims`, laid
    side by side (one lane: a single run).

    `step(st, flow_ops, topo_ops) -> (next_state, emit_row)` runs the seven
    phases in order; every operand must live on `device`."""
    pc, tm = cfg.proto, cfg.timing
    env = phases.make_env(dims, cfg, n_flows, device, lanes)
    dev = env.device
    P, NSRV, NSW, PROP = env.P, env.NSRV, env.NSW, env.PROP_MAX
    lead = env.lead
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
            d_q=full((P, env.NDST), -1), d_cnt=z((P, env.NDST)),
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
            stat_drops=z(lead), stat_collisions=z(lead),
            stat_allocs=z(lead), stat_overflow=z(lead),
            stat_pauses=z(lead), stat_pfc_ticks=z(lead),
            occ_hist=z(lead + (cfg.occ_bins,)),
            flows_hist=z(lead + (cfg.flows_bins,)),
            qlen_hist=z(lead + (cfg.occ_bins,)),
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


def quiescent(env, st: SimState, ops: FlowOperands) -> torch.Tensor:
    """Per lane, True iff no future tick can change anything but the
    closed-form leaves `_finish_tail` reconstructs: every flow that will
    ever arrive has completed, nothing is in flight on wires or queues,
    every delayed feedback / retransmit credit has landed, and every
    backpressure signal has drained (see `repro.sim.engine.quiescent`). A
    (lanes,) bool tensor."""
    K = env.lanes

    def rows(x):                  # lane-contiguous leading axis
        return x.reshape(K, -1).all(1)

    def ring(x):                  # (RING, lanes * F)
        return x.reshape(x.shape[0], K, -1).all(2).all(0)

    flows_done = rows((st.done >= 0) | (ops.arrival >= PHANTOM_ARRIVAL))
    net_empty = (rows(st.wire_f < 0)
                 & rows(st.qtail == st.qhead)
                 & rows(st.f_cnt == 0)
                 & ring(st.ack_ring == 0)
                 & ring(st.mark_ring == 0)
                 & ring(st.u_ring == 0.0)
                 & ring(st.retx_ring == 0)
                 & ring(st.sfc_ring == 0))
    signals_clear = (rows(st.pl_tail == st.pl_head)
                     & rows(st.bloom_counts == 0)
                     & rows(~st.bloom_mid) & rows(~st.bloom_rx)
                     & rows(~st.f_paused)
                     & rows(~st.pfc_paused)
                     & rows(st.ing_occ == 0))
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
    `step` once on the quiescent state. Writes `emits[active:]` in place.
    In a batch every lane is quiescent at `active` (each lane's own
    active tick may be earlier: stepping a quiescent lane on to `active`
    is what this closed form reconstructs)."""
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


def copy_state(dst: SimState, src: SimState) -> None:
    """``dst[i].copy_(src[i])`` for every leaf, as one simultaneous
    assignment: a source leaf that shares memory with another destination
    leaf is cloned first, so no leaf is read after it was overwritten; a
    source leaf that IS its destination is left alone."""
    owners = {leaf.untyped_storage().data_ptr() for leaf in dst}
    pending = []
    for d, x in zip(dst, src):
        if x.data_ptr() == d.data_ptr() and x.shape == d.shape:
            continue
        if x.untyped_storage().data_ptr() in owners:
            x = x.clone()
        pending.append((d, x))
    for d, x in pending:
        d.copy_(x)


class TickLoop:
    """Steps ticks one at a time as eager torch ops (the CPU runner)."""

    def __init__(self, step, st: SimState, flow_ops, topo_ops, emits):
        self.step, self.flow_ops, self.topo_ops = step, flow_ops, topo_ops
        self.state, self.emits = st, emits

    def _eager(self, st, t0, n):
        for t in range(t0, t0 + n):
            st, row = self.step(st, self.flow_ops, self.topo_ops)
            self.emits[t] = row
        return st

    def advance(self, t0: int, n: int) -> None:
        """Step ticks [t0, t0 + n), writing their emit rows."""
        self.state = self._eager(self.state, t0, n)


class TickGraph(TickLoop):
    """Steps ticks `k` = GRAPH_TICKS at a time by replaying ONE captured
    CUDA graph.

    The first `k` ticks run eagerly, on a side stream on the card: they
    load the kernels and warm everything a capture must not start. Then
    the state is cloned into static tensors, and the graph of `_body` is
    captured: `k` chained steps from the static state, each emit row into
    a static (k, W) buffer, the new state copied back into the static
    state (`copy_state`). A replay moves the rows to `emits[t0:t0+k]` with
    one copy. Ticks left over (< k) step eagerly from the static state and
    are copied back. The kernels' launches inside a replay happen without
    their wrappers, so each replay adds the counts captured with the
    graph (`kernel_ops.add_launches`). On the CPU `_body` runs eagerly in
    place of a replay (what the tests hold against `TickLoop`). A capture
    or replay that fails raises: there is no eager retry."""

    def __init__(self, step, st, flow_ops, topo_ops, emits):
        super().__init__(step, st, flow_ops, topo_ops, emits)
        self.k = GRAPH_TICKS
        self.cuda = emits.device.type == "cuda"
        self.rows = None        # (k, W) static emit rows once prepared
        self.graph = None
        self.per_replay = {}

    def _body(self) -> None:
        st = self.state
        for i in range(self.k):
            st, row = self.step(st, self.flow_ops, self.topo_ops)
            self.rows[i].copy_(row)
        copy_state(self.state, st)

    def _prepare(self, t0: int) -> None:
        """Warm-up ticks [t0, t0 + k) eagerly, then the static state and
        the capture."""
        dev = self.emits.device
        side = torch.cuda.Stream(dev) if self.cuda else None
        if side is not None:
            side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side) if side is not None else nullcontext():
            st = self._eager(self.state, t0, self.k)
        if side is not None:
            torch.cuda.current_stream(dev).wait_stream(side)
        self.state = SimState(*(leaf.clone() for leaf in st))
        self.rows = torch.zeros((self.k,) + self.emits.shape[1:],
                                dtype=self.emits.dtype, device=dev)
        if self.cuda:
            self.graph = torch.cuda.CUDAGraph()
            kernel_ops.reset_captured()
            with torch.cuda.graph(self.graph):
                self._body()
            self.per_replay = dict(kernel_ops.captured)

    def _replay(self) -> None:
        if self.graph is None:
            self._body()
            return
        self.graph.replay()
        kernel_ops.add_launches(self.per_replay)

    def advance(self, t0: int, n: int) -> None:
        t, end = t0, t0 + n
        while end - t >= self.k:
            if self.rows is None:
                self._prepare(t)
            else:
                self._replay()
                self.emits[t:t + self.k].copy_(self.rows)
            t += self.k
        if t < end:
            st = self._eager(self.state, t, end - t)
            if self.rows is None:
                self.state = st
            else:
                copy_state(self.state, st)


def simulate(dims: TopoDims, cfg: SimConfig, flow_ops: FlowOperands,
             topo_ops, n_ticks: int, *, segment: int = DEFAULT_SEGMENT,
             early_exit: bool = True):
    """Run `n_ticks` ticks on the operands' device.

    Returns `(state, emits[T, 3 + trace channels], active_ticks)`, all on
    the device but `active_ticks`, the tick the run actually stepped to
    before the closed-form tail took over (= n_ticks when no early exit).
    The segmented runner reads `quiescent` once per `segment` ticks. On a
    CUDA device the ticks replay a captured CUDA graph (`TickGraph`), on
    the CPU they step eagerly (`TickLoop`). Runs under
    `torch.inference_mode` (no autograd bookkeeping per op), so the
    returned tensors are inference tensors."""
    st, emits, active = simulate_lanes(dims, cfg, flow_ops, topo_ops,
                                       n_ticks, 1, segment=segment,
                                       early_exit=early_exit)
    return st, emits, int(active[0])


def simulate_lanes(dims: TopoDims, cfg: SimConfig, flow_ops: FlowOperands,
                   topo_ops, n_ticks: int, lanes: int, *,
                   segment: int = DEFAULT_SEGMENT, early_exit: bool = True):
    """`simulate` of `lanes` simulations laid side by side (operands
    stacked by `sweep.stack_operands` / `sweep.stack_topos`, fabrics
    padded to `dims`): one step, one graph and one fused switch step
    launch per tick for all lanes. Returns `(state, emits[T, *lead, W],
    active_ticks)` with ``lead`` = (lanes,) (() for one lane) and
    `active_ticks` a (lanes,) numpy array: each lane's own active tick,
    as the reference's vmapped runner gives it."""
    with torch.inference_mode():
        env, init_state, step = make_step(
            dims, cfg, flow_ops.arrival.shape[0] // lanes,
            flow_ops.arrival.device, lanes)
        emits = torch.zeros((int(n_ticks),) + env.lead
                            + (emit_width(cfg, dims),),
                            dtype=I32, device=env.device)
        runner = TickGraph if env.device.type == "cuda" else TickLoop
        ticks = runner(step, init_state(), flow_ops, topo_ops, emits)
        return run_ticks(env, ticks, step, flow_ops, topo_ops, int(n_ticks),
                         segment, early_exit)


def emit_width(cfg: SimConfig, dims: TopoDims) -> int:
    return EMIT_BASE + trace_layout(cfg.trace, dims.n_ports,
                                    dims.n_switches).width


def run_ticks(env, ticks: TickLoop, step, flow_ops, topo_ops, n_ticks: int,
              segment: int = DEFAULT_SEGMENT, early_exit: bool = True):
    """The segmented runner over `ticks` (a `TickLoop` or `TickGraph` whose
    state is the initial state and whose emits are (n_ticks, *lead, W)):
    `simulate_lanes` without the set-up. The active ticks come back as a
    (lanes,) numpy array.

    Each lane's active tick is the reference's vmapped while-loop's: the
    first segment boundary at which the lane is quiescent (the K bits are
    read once per segment, outside any graph), or the horizon. The batch
    steps on while any lane is active; a quiescent lane stepped past its
    own boundary changes only what `_finish_tail` reconstructs in closed
    form, so running that tail from the batch's tick gives every lane the
    state and emits of its own."""
    emits = ticks.emits
    active = np.full(env.lanes, -1, dtype=np.int64)     # -1: still active
    if not early_exit or n_ticks == 0:
        ticks.advance(0, n_ticks)
        active[:] = n_ticks
        return ticks.state, emits, active

    # a segment never exceeds the horizon
    seg = min(segment, n_ticks)
    n_full, rem = divmod(n_ticks, seg)
    t = 0

    def all_quiescent() -> bool:
        quiet = quiescent(env, ticks.state, flow_ops).cpu().numpy()
        active[(active < 0) & quiet] = t
        return bool((active >= 0).all())

    while t < n_full * seg and not all_quiescent():
        ticks.advance(t, seg)
        t += seg
    if rem and not all_quiescent():
        # horizon not a segment multiple: run the remainder unless the loop
        # already went quiescent (then the tail covers it)
        ticks.advance(t, rem)
        t += rem
    active[active < 0] = t
    st = _finish_tail(env, ticks.state, emits, topo_ops, n_ticks, t,
                      step, flow_ops)
    return st, emits, active


# How a batch lays out each SimState leaf's lane axis on the device (see
# `to_numpy`): the leading axis holds the lanes' rows one after another,
# the feedback rings' second axis holds the lanes' flows, the counters and
# histograms lead with the lane axis itself (absent for one lane), and `t`
# is the batch's.
_RINGS = frozenset({"ack_ring", "mark_ring", "u_ring", "retx_ring",
                    "sfc_ring"})
_PER_LANE = frozenset({"stat_drops", "stat_collisions", "stat_allocs",
                       "stat_overflow", "stat_pauses", "stat_pfc_ticks",
                       "occ_hist", "flows_hist", "qlen_hist"})
# leaves holding the batch's flow ids: (flow * 2 + mark) entries and flow
# ids, -1 where empty, and the NIC's DRR pointer (flow + 1; 0 before the
# first pick), each with (the factor of the lane's flow offset, the least
# value that holds an id)
_FLOW_IDS = {"qbuf": (2, 0), "wire_f": (2, 0), "pl": (1, 0),
             "nic_ptr": (1, 1)}


def to_numpy(st: SimState, lanes: int = 0) -> SimState:
    """A SimState with every leaf copied to a host numpy array. Given the
    lane count of a batch (`simulate_lanes`), in the reference's batched
    layout instead: every leaf (lanes, ...) with lane-local ids, as
    `repro.sim.sweep.run_batch` returns it."""
    host = SimState(*(leaf.detach().cpu().numpy() for leaf in st))
    if not lanes:
        return host
    K, F = lanes, host.done.shape[0] // lanes
    n_lead = host.stat_drops.ndim
    lane = np.arange(K)
    out = {}
    for name, v in host._asdict().items():
        if name == "t":
            v = np.full(K, v, v.dtype)
        elif name in _RINGS:
            v = np.ascontiguousarray(
                v.reshape(v.shape[0], K, -1).swapaxes(0, 1))
        elif name in _PER_LANE:
            v = v.reshape((K,) + v.shape[n_lead:])
        else:
            v = v.reshape((K, -1) + v.shape[1:])
        if name in _FLOW_IDS:
            factor, floor = _FLOW_IDS[name]
            off = (factor * F * lane).reshape((K,) + (1,) * (v.ndim - 1))
            v = np.where(v >= floor, v - off, v).astype(v.dtype)
        out[name] = v
    return SimState(**out)


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
