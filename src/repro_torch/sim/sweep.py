"""Batched experiment sweeps: K simulations as one batched run on the card
(torch port of `repro.sim.sweep`).

The paper's results are sweeps over protocol x topology x workload x load
x incast x seed. Every case of one protocol variant runs as ONE batched
simulation: the K lanes are laid side by side as one larger fabric of K
disjoint copies (`sim.phases.ctx`), the lane offsets put into the
operands' id tables once, here, when the batch is stacked. A tick then
computes no lane term: the step, the CUDA graph of `engine.TickGraph`
(captured once per batch) and the one launch of the fused switch step
(one thread block cluster per lane) serve every lane, and a batch of
one lane is a single run.

Padding contracts (the reference's, unchanged)
----------------------------------------------
Workloads in a batch are padded to a common flow count ``F_max`` (rounded
up to ``PAD_MULTIPLE``). Padded "phantom" flows are inert by construction
(`workload.pad_flowset`): arrival ``PHANTOM_ARRIVAL`` (2**30), size 0,
routes all -1. Topologies are padded to a common `TopoDims` (max ports /
servers / switches / ``prop_max``, the padded wire-ring length); each
lane's wires wrap at its own link delay, so mixed latencies share a
batch. Phantom ports / switches / servers never hold occupancy, never
transmit and are masked out of the sampled histograms (`port_valid` /
`switch_valid`). A lane of a padded batch equals its unpadded serial run
leaf for leaf once trimmed (`select_config`).

Stacking
--------
Lane k's port ids (`routes`) are offset by k*P, its switch ids
(`port_switch`, `feeds`) by k*NSW and its server ids (`src`) by k*NSRV;
-1 entries stay -1. The flow ids the state holds (queue and wire
entries, resume rings, NIC pointers) become the batch's, k*F on, by
construction. `fid` and `dst` stay lane-local: the Bloom positions, the
flow-table bucket and the queue hashes derive from them, and `dst` is a
column of the (port, dst) tables. A fabric scalar (`buffer_limit`,
`occ_ref`, `prop_ticks`) stays 0-d when every lane agrees on it, and
becomes a (K,) table when they differ. `engine.to_numpy(st, K)` turns the
batch's state back into the reference's (K, ...) layout, once per run.

Execution
---------
`run_batch` runs every lane as one chunk on one device; the reference's
execution tier (chunking against a memory budget, several devices,
journaled chunks and resume) is not ported yet. `lane_state_bytes` gives
the per-lane footprint that tier plans with, counted on the ``meta``
device without allocating. The tick count each lane was active for
(before its quiescent tail) is kept for `last_active_ticks`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from . import engine, metrics
from .config import SimConfig
from .engine import FlowOperands, SimState
from .topology import (MAX_HOPS, TopoDims, TopoOperands, Topology,
                       build_cached, pack_topo)
from .workload import FlowSet, pad_flowset

# Default padding quantum for F_max: coarse enough that ragged grids share
# one batch shape, fine enough not to waste memory on tiny sims.
PAD_MULTIPLE = 64

# SimState leaves carrying a per-flow axis (axis 0 once the lane axis is
# selected away), used to trim padded state back to a workload's true F.
_PER_FLOW_AXIS0 = {
    "rem_src", "sent", "acked", "delivered", "done", "cwnd", "cwnd_ref",
    "rate", "rate_target", "tokens", "alpha", "ack_seen", "mark_seen",
    "cc_timer", "since_dec", "f_q", "f_cnt", "f_paused", "sfc_until",
}
_PER_FLOW_AXIS1 = {"ack_ring", "mark_ring", "u_ring", "retx_ring",
                   "sfc_ring"}
# ... and the leaves carrying topology axes, trimmed back to a fabric's
# true port/server/switch counts after a padded multi-topology run.
_PER_PORT_AXIS0 = {
    "qbuf", "qhead", "qtail", "qptr", "qsrf", "d_q", "d_cnt",
    "bloom_counts", "bloom_mid", "bloom_rx", "pl", "pl_head", "pl_tail",
    "ing_occ", "pfc_paused", "wire_f", "wire_hop", "tx_ewma",
}
_PER_SERVER_AXIS0 = {"nic_ptr"}
_PER_SERVER_AXIS1 = {"d_q", "d_cnt"}
_PER_SWITCH_AXIS0 = {"bucket_cnt"}
# ... and the leaves whose shapes scale with the padded wire-ring length
# `TopoDims.prop_max`: the wires themselves (axis 1 = PROP_MAX) and the
# feedback delay lines (axis 0 = MAX_HOPS * prop_max + 2).
_PER_PROP_AXIS1 = {"wire_f", "wire_hop"}
_FB_RING_AXIS0 = {"ack_ring", "mark_ring", "u_ring", "sfc_ring"}

# per-lane active ticks of the most recent `run_batch`
_LAST_ACTIVE: Optional[np.ndarray] = None


def last_active_ticks() -> Optional[np.ndarray]:
    """Per-lane active ticks of the most recent `run_batch` (the tick each
    lane stepped to before its closed-form quiescent tail; n_ticks without
    early exit), or None before the first."""
    return _LAST_ACTIVE


def padded_count(flowsets: Sequence[FlowSet]) -> int:
    f_max = max(f.n_flows for f in flowsets)
    return int(-(-max(f_max, 1) // PAD_MULTIPLE) * PAD_MULTIPLE)


def _offset(ids: torch.Tensor, by: int) -> torch.Tensor:
    """`ids` moved `by` places, -1 entries (none) kept."""
    return torch.where(ids >= 0, ids + by, ids)


def _lane_scalar(values: Sequence[torch.Tensor]) -> torch.Tensor:
    """One 0-d scalar when every lane agrees, else the (K,) table."""
    first = values[0]
    if all(torch.equal(v, first) for v in values[1:]):
        return first
    return torch.stack(list(values))


def stack_operands(flowsets: Sequence[FlowSet], cfg: SimConfig, f_max: int,
                   dims: TopoDims, device="cuda") -> FlowOperands:
    """Pad every FlowSet to `f_max` and lay the lanes' operands side by
    side on `device`: lane k's routes name ports k*P on and its sources
    servers k*NSRV on (`dims`: the batch's padded fabric)."""
    lanes = []
    for k, flows in enumerate(flowsets):
        ops = engine.pack_flows(pad_flowset(flows, f_max), cfg, "cpu")
        lanes.append(ops._replace(
            routes=_offset(ops.routes, k * dims.n_ports),
            src=ops.src + k * dims.n_servers))
    return FlowOperands(*[torch.cat(leaves).to(resolve_device(device))
                          for leaves in zip(*lanes)])


def _topo_list(topo: Union[Topology, Sequence[Topology]],
               k: int) -> List[Topology]:
    if isinstance(topo, Topology):
        return [topo] * k
    topos = list(topo)
    if len(topos) != k:
        raise ValueError(f"{len(topos)} topologies for {k} workloads")
    return topos


def batch_dims(topos: Sequence[Topology]) -> TopoDims:
    """The common padded `TopoDims` of a (possibly mixed) topology batch."""
    dims = TopoDims.of(topos[0])
    for t in topos[1:]:
        dims = dims.union(TopoDims.of(t))
    return dims


def stack_topos(topos: Sequence[Topology], cfg: SimConfig, dims: TopoDims,
                device="cuda") -> TopoOperands:
    """Pad every fabric to `dims` and lay them side by side on `device`:
    lane k's switch ids k*NSW on; each scalar 0-d when the lanes agree on
    it, else a (K,) table."""
    lanes = []
    for k, topo in enumerate(topos):
        ops = pack_topo(topo, infinite_buffer=cfg.proto.infinite_buffer,
                        dims=dims, device="cpu")
        lanes.append(ops._replace(
            port_switch=_offset(ops.port_switch, k * dims.n_switches),
            feeds=_offset(ops.feeds, k * dims.n_switches)))
    leaves = [_lane_scalar(vals) if vals[0].dim() == 0 else torch.cat(vals)
              for vals in zip(*lanes)]
    return TopoOperands(*[x.to(resolve_device(device)) for x in leaves])


def lane_state_bytes(dims: TopoDims, cfg: SimConfig, n_flows: int,
                     n_ticks: int = 0) -> int:
    """Bytes one batch lane holds on the device: the padded SimState (~F x
    H + P x Q x CAP ints, counted from the shapes `engine.make_step` would
    allocate, made on the ``meta`` device: nothing is allocated) plus its
    (T, 3 + trace channels) emit rows. Includes the `dims.prop_max`-padded
    wire rings and feedback delay lines, so a mixed-latency batch bills
    every lane at the padded size."""
    _, init_state, _ = engine.make_step(dims, engine.static_cfg(cfg),
                                        n_flows, "meta")
    state = sum(leaf.numel() * leaf.element_size() for leaf in init_state())
    return state + n_ticks * engine.emit_width(cfg, dims) * 4


def trim_state(state: SimState, n_flows: int, dims: TopoDims) -> SimState:
    """Trim the per-flow, per-port/server/switch and per-prop leaves of an
    (unbatched, host numpy) SimState back to the workload's true F and the
    fabric's true shapes, dropping the phantom tails a padded run carries.

    Wire rings are trimmed to `dims.prop_max` slots (slots beyond a lane's
    true delay are never touched). The feedback delay lines are
    *re-indexed* rather than sliced: two runs padded to different
    `prop_max` store the same pending feedback at different absolute rows
    (the ring length is the wrap modulus), so rows are rotated to
    offset-from-`state.t` order and cut at the fabric's own worst-case
    delay — after which a prop-padded run is leaf-for-leaf comparable with
    its unpadded serial twin."""
    t = int(np.asarray(state.t))
    out = {}
    for name, leaf in state._asdict().items():
        v = np.asarray(leaf)
        if name in _PER_FLOW_AXIS0:
            v = v[:n_flows]
        elif name in _PER_FLOW_AXIS1:
            v = v[:, :n_flows]
        if name in _PER_PORT_AXIS0:
            v = v[:dims.n_ports]
        elif name in _PER_SERVER_AXIS0:
            v = v[:dims.n_servers]
        elif name in _PER_SWITCH_AXIS0:
            v = v[:dims.n_switches]
        if name in _PER_SERVER_AXIS1:
            v = v[:, :dims.n_servers]
        if name in _PER_PROP_AXIS1:
            v = v[:, :dims.prop_max]
        elif name in _FB_RING_AXIS0:
            ring = MAX_HOPS * dims.prop_max + 2
            if ring > v.shape[0]:
                raise ValueError(
                    f"trim_state: dims.prop_max={dims.prop_max} "
                    f"implies a {ring}-row feedback ring but the "
                    f"state holds {v.shape[0]} rows — pass the "
                    "fabric's own TopoDims, not a batch union")
            v = v[(t + np.arange(ring)) % v.shape[0]]
        out[name] = v
    return SimState(**out)


def select_config(batched_state: SimState, k: int, n_flows: int,
                  dims: TopoDims) -> SimState:
    """Extract lane `k` of a batched host SimState (the reference's
    layout), trimming its leaves back to the case's true flow count and
    fabric (`dims`) so it is leaf-for-leaf comparable with an unpadded
    serial `engine.run`."""
    lane = SimState(**{name: np.asarray(leaf)[k]
                       for name, leaf in batched_state._asdict().items()})
    return trim_state(lane, n_flows, dims)


def run_batch(topo: Union[Topology, Sequence[Topology]],
              flowsets: Sequence[FlowSet], cfg: SimConfig, n_ticks: int, *,
              device="cuda", early_exit: bool = True):
    """Run K workloads under one protocol config as ONE batched simulation
    on `device` (the card unless the caller passes ``device="cpu"``), all
    lanes as one chunk. `topo` is one Topology shared by every lane or a
    per-lane sequence (mixed fabrics are padded to a common `TopoDims`,
    mixed link delays ride the lanes as per-lane `prop_ticks`). Returns
    (batched_state, emits[K, T, 3 + trace channels]) as host numpy in the
    reference's layout; `select_config` views one lane,
    `last_active_ticks()` gives each lane's active ticks. `early_exit`
    False steps every tick (for A/B runs)."""
    global _LAST_ACTIVE
    dev = resolve_device(device)
    K = len(flowsets)
    topos = _topo_list(topo, K)
    dims = batch_dims(topos)
    f_max = padded_count(flowsets)
    st, emits, active = engine.simulate_lanes(
        dims, cfg, stack_operands(flowsets, cfg, f_max, dims, dev),
        stack_topos(topos, cfg, dims, dev), int(n_ticks), K,
        early_exit=early_exit)
    _LAST_ACTIVE = active
    emits = emits.cpu().numpy().reshape(int(n_ticks), K, -1)
    return engine.to_numpy(st, K), np.ascontiguousarray(
        emits.swapaxes(0, 1))


@dataclass
class CaseResult:
    """One grid point of a sweep, unpacked back to host."""
    label: str
    proto: str
    cfg: SimConfig
    flows: FlowSet
    state: SimState            # per-flow/topo leaves trimmed to true shapes
    emits: np.ndarray          # (T, 3 + trace channels)
    active_ticks: int          # stepped before the quiescent tail
    metrics: Optional[metrics.RunMetrics] = None


def _case_topo(cfg: SimConfig, default: Topology) -> Topology:
    """The fabric a case runs on: its own `cfg.clos`, through the build
    cache; `default` is reused when it already matches."""
    if cfg.clos == default.params:
        return default
    return build_cached(cfg.clos)


def run_grid(topo: Topology,
             cases: Sequence[Tuple[str, SimConfig, FlowSet]],
             n_ticks: Optional[int] = None, drain: int = 20_000, *,
             device="cuda") -> List[CaseResult]:
    """Run an arbitrary (label, SimConfig, FlowSet) grid; results in case
    order, each summarized by `metrics.summarize`.

    Each case runs on the fabric named by its own ``cfg.clos`` (``topo`` is
    the default instance for cases that match it). Cases are grouped by
    `engine.static_cfg` (the protocol/timing config: its flags choose the
    phases' code paths, so BFC and DCTCP cannot share a batch), and each
    group — mixed topologies and link delays included — runs as ONE
    batched simulation (`run_batch`). All groups share `n_ticks` (default:
    max horizon + `drain`)."""
    if n_ticks is None:
        n_ticks = int(max(f.horizon for _, _, f in cases) + drain)
    groups: Dict[SimConfig, List[int]] = {}
    for i, (_, cfg, _) in enumerate(cases):
        groups.setdefault(engine.static_cfg(cfg), []).append(i)

    topos = [_case_topo(cfg, topo) for _, cfg, _ in cases]
    results: List[Optional[CaseResult]] = [None] * len(cases)
    for idxs in groups.values():
        group_topos = [topos[i] for i in idxs]
        st, emits = run_batch(group_topos, [cases[i][2] for i in idxs],
                              cases[idxs[0]][1], n_ticks, device=device)
        active = last_active_ticks()
        for k, i in enumerate(idxs):
            label, case_cfg, flows = cases[i]
            case_topo = group_topos[k]
            state_k = select_config(st, k, flows.n_flows,
                                    TopoDims.of(case_topo))
            m = metrics.summarize(
                label, state_k, emits[k], flows,
                n_links=case_topo.n_ports,
                occ_bin_ref=case_topo.params.switch_buffer_pkts,
                cap=case_cfg.proto.queue_cap)
            results[i] = CaseResult(label=label, proto=case_cfg.proto.name,
                                    cfg=case_cfg, flows=flows,
                                    state=state_k, emits=emits[k],
                                    active_ticks=int(active[k]), metrics=m)
    return results
