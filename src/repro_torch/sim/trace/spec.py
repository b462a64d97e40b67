"""TraceSpec: which per-tick channels the simulator captures.

Torch port of `repro.sim.trace.spec`, which is pure Python; the port keeps
its own copy so that it never imports the JAX package. A `TraceSpec` is a
frozen selection of channel groups on `SimConfig.trace`; the default
all-off spec emits exactly the 3 legacy columns and runs no capture code.

`layout(spec, n_ports, n_switches)` is the single source of truth for the
channel ordering: the capture code (`trace.capture`) and the engine's emit
buffer width derive from it, and it is the same ordering the JAX package's
spooled traces and golden fixtures carry.

Channel groups (all columns int32, captured once per tick):

===========  ===========================================================
group        channels
===========  ===========================================================
``occ``      ``sw_occ[NSW]`` — per-switch buffer occupancy at tick start
``pause``    ``paused_q[P]`` — head-of-line-paused queues per port;
             ``pfc[P]`` — PFC pause bit per port; ``pause_tx[1]`` —
             pause frames sent this tick
``flow``     ``started/completed/active/probe/delivered`` — flow-state
             transition counts, probe-flow progress, cumulative packet
             deliveries (one column each)
``kernel``   ``sel_q[P]`` — the switch scheduler's queue pick (-1 = no
             transmission); ``can_tx[P]`` — pick exists (from the
             fused switch-step kernel or its plain version).
===========  ===========================================================

Per-flow channels are deliberately *aggregates* (F columns per tick would
dwarf the SimState itself); per-flow completion ticks live in the final
state's ``done`` vector, which the spooled chunk already carries.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import List, NamedTuple, Tuple

# Width of the legacy emit row ([max buffer, pfc-paused ports, probe]);
# trace channels are appended after these columns in the emit buffer.
EMIT_BASE = 3


@dataclass(frozen=True)
class TraceSpec:
    """Opt-in channel-group selection; all-off (the default) is zero-cost."""
    switch_occ: bool = False    # 'occ' group
    port_pause: bool = False    # 'pause' group
    flow_state: bool = False    # 'flow' group
    kernel_path: bool = False   # 'kernel' group

    @property
    def enabled(self) -> bool:
        return any(getattr(self, f.name) for f in fields(self))

    @classmethod
    def full(cls) -> "TraceSpec":
        return cls(switch_occ=True, port_pause=True, flow_state=True,
                   kernel_path=True)

    def describe(self) -> str:
        on = [f.name for f in fields(self) if getattr(self, f.name)]
        return "off" if not on else "+".join(on)


class Channel(NamedTuple):
    name: str
    group: str
    start: int      # first column within the trace block (0-based, i.e.
    width: int      # emit column EMIT_BASE + start)


class TraceLayout(NamedTuple):
    """Resolved column map of one spec on one (padded) fabric shape."""
    channels: Tuple[Channel, ...]
    width: int

    def slice_of(self, name: str) -> slice:
        for ch in self.channels:
            if ch.name == name:
                return slice(ch.start, ch.start + ch.width)
        raise KeyError(f"no trace channel {name!r}; have "
                       f"{[c.name for c in self.channels]}")

    def groups(self) -> List[str]:
        out: List[str] = []
        for ch in self.channels:
            if ch.group not in out:
                out.append(ch.group)
        return out

    def meta(self) -> List[List]:
        """JSON-able form recorded in the RunStore manifest."""
        return [[c.name, c.group, c.start, c.width] for c in self.channels]

    @classmethod
    def from_meta(cls, meta) -> "TraceLayout":
        chans = tuple(Channel(str(n), str(g), int(s), int(w))
                      for n, g, s, w in meta)
        width = max((c.start + c.width for c in chans), default=0)
        return cls(channels=chans, width=width)


def layout(spec: TraceSpec, n_ports: int, n_switches: int) -> TraceLayout:
    """Column layout of `spec` on a fabric padded to (n_ports, n_switches).

    `trace.capture.capture_row` emits columns in exactly this order —
    keep the two in lockstep (test_sim_trace pins the correspondence)."""
    chans: List[Channel] = []
    at = 0

    def add(name: str, group: str, width: int):
        nonlocal at
        chans.append(Channel(name, group, at, width))
        at += width

    if spec.switch_occ:
        add("sw_occ", "occ", n_switches)
    if spec.port_pause:
        add("paused_q", "pause", n_ports)
        add("pfc", "pause", n_ports)
        add("pause_tx", "pause", 1)
    if spec.flow_state:
        for name in ("started", "completed", "active", "probe",
                     "delivered"):
            add(name, "flow", 1)
    if spec.kernel_path:
        add("sel_q", "kernel", n_ports)
        add("can_tx", "kernel", n_ports)
    return TraceLayout(channels=tuple(chans), width=at)


def split_emits(emits, lay: TraceLayout):
    """Split a full-width emit buffer (..., EMIT_BASE + C) into the legacy
    (..., 3) rows and the (..., C) trace block (empty-width when off)."""
    return emits[..., :EMIT_BASE], emits[..., EMIT_BASE:EMIT_BASE + lay.width]
