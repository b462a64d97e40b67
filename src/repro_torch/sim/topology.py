"""Clos topology + routing for the packet simulator (paper §4.1).

Torch port of `repro.sim.topology`: the host-side fabric description stays
numpy; `pack_topo` returns the per-fabric operand tensors on a device.

Everything that transmits is an *egress port*. Ports are flattened into one
global index space so the whole network updates as dense tensors:

  [0, n_servers)                         server NIC uplink ports
  [nic_end, nic_end + n_tor*ports_tor)   ToR ports: per ToR, first
                                         `servers_per_tor` down-ports (to its
                                         servers) then `n_spine` up-ports
  [tor_end, tor_end + n_spine*n_tor)     spine down-ports (to each ToR)

A flow's route is the sequence of egress ports it is *transmitted from*:
  inter-ToR: [src NIC, src ToR up-port(spine s), spine s down-port(dst ToR),
              dst ToR down-port(dst server)]
  intra-ToR: [src NIC, dst ToR down-port(dst server), -1, -1]
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device

MAX_HOPS = 4


@dataclass(frozen=True)
class ClosParams:
    n_servers: int = 128
    n_tor: int = 8
    n_spine: int = 8
    # timing, in ticks (1 tick = one MTU transmission time at line rate:
    # 1 KB at 100 Gbps = 80 ns)
    prop_ticks: int = 12          # ~1 us per link
    switch_buffer_pkts: int = 12288  # 12 MB of 1 KB packets

    @property
    def servers_per_tor(self) -> int:
        if self.n_servers % self.n_tor:
            raise ValueError(f"{self.n_servers} servers do not split evenly "
                             f"over {self.n_tor} ToRs")
        return self.n_servers // self.n_tor

    @property
    def ports_per_tor(self) -> int:
        return self.servers_per_tor + self.n_spine


@dataclass
class Topology:
    params: ClosParams
    n_ports: int
    n_switches: int
    # per-port metadata (numpy)
    port_switch: np.ndarray      # switch id owning the port; -1 for NIC ports
    port_is_nic: np.ndarray      # bool
    # derived index helpers
    nic_base: int = 0
    tor_base: int = field(default=0)
    spine_base: int = field(default=0)

    # ---- port index helpers -------------------------------------------------
    def nic_port(self, server: np.ndarray) -> np.ndarray:
        return np.asarray(server)

    def tor_of_server(self, server: np.ndarray) -> np.ndarray:
        return np.asarray(server) // self.params.servers_per_tor

    def tor_down_port(self, tor, server) -> np.ndarray:
        local = np.asarray(server) % self.params.servers_per_tor
        return self.tor_base + np.asarray(tor) * self.params.ports_per_tor + local

    def tor_up_port(self, tor, spine) -> np.ndarray:
        return (self.tor_base + np.asarray(tor) * self.params.ports_per_tor
                + self.params.servers_per_tor + np.asarray(spine))

    def spine_down_port(self, spine, tor) -> np.ndarray:
        return self.spine_base + np.asarray(spine) * self.params.n_tor + np.asarray(tor)


def build(params: ClosParams) -> Topology:
    n_nic = params.n_servers
    n_tor_ports = params.n_tor * params.ports_per_tor
    n_spine_ports = params.n_spine * params.n_tor
    n_ports = n_nic + n_tor_ports + n_spine_ports
    n_switches = params.n_tor + params.n_spine

    port_switch = np.full(n_ports, -1, np.int32)
    port_is_nic = np.zeros(n_ports, bool)
    port_is_nic[:n_nic] = True

    tor_base = n_nic
    spine_base = n_nic + n_tor_ports
    for tor in range(params.n_tor):
        lo = tor_base + tor * params.ports_per_tor
        port_switch[lo:lo + params.ports_per_tor] = tor
    for spine in range(params.n_spine):
        lo = spine_base + spine * params.n_tor
        port_switch[lo:lo + params.n_tor] = params.n_tor + spine

    topo = Topology(params=params, n_ports=n_ports, n_switches=n_switches,
                    port_switch=port_switch, port_is_nic=port_is_nic)
    topo.tor_base = tor_base
    topo.spine_base = spine_base
    return topo


@functools.lru_cache(maxsize=None)
def build_cached(params: ClosParams) -> Topology:
    """`build(params)`, memoised on the (frozen, hashable) ClosParams: a
    grid that names one fabric in many cases builds it once. Callers must
    not mutate the returned Topology."""
    return build(params)


def routes_for_flows(topo: Topology, src: np.ndarray, dst: np.ndarray,
                     spine_choice: np.ndarray) -> np.ndarray:
    """Vectorized route computation.

    Returns (n_flows, MAX_HOPS) int32 of egress port ids, -1 padded. The hop
    *after* the last valid port is delivery at the destination server.
    """
    src = np.asarray(src); dst = np.asarray(dst)
    n = src.shape[0]
    routes = np.full((n, MAX_HOPS), -1, np.int32)
    s_tor = topo.tor_of_server(src)
    d_tor = topo.tor_of_server(dst)
    routes[:, 0] = topo.nic_port(src)
    intra = s_tor == d_tor
    # intra-ToR: NIC -> ToR down-port to dst
    routes[intra, 1] = topo.tor_down_port(d_tor[intra], dst[intra])
    # inter-ToR: NIC -> ToR up (spine) -> spine down (dst ToR) -> ToR down (dst)
    inter = ~intra
    sp = np.asarray(spine_choice)[inter] % topo.params.n_spine
    routes[inter, 1] = topo.tor_up_port(s_tor[inter], sp)
    routes[inter, 2] = topo.spine_down_port(sp, d_tor[inter])
    routes[inter, 3] = topo.tor_down_port(d_tor[inter], dst[inter])
    return routes


class TopoDims(NamedTuple):
    """The topology-derived *shapes* of the simulator state.

    `prop_max` is the wire-ring length: wires are `(P, prop_max)` tensors
    whose indexing wraps at the fabric's `TopoOperands.prop_ticks`."""
    n_ports: int
    n_servers: int
    n_switches: int
    prop_max: int

    @classmethod
    def of(cls, topo: Topology) -> "TopoDims":
        return cls(n_ports=topo.n_ports, n_servers=topo.params.n_servers,
                   n_switches=topo.n_switches,
                   prop_max=topo.params.prop_ticks)

    def union(self, other: "TopoDims") -> "TopoDims":
        """The smallest dims both fabrics pad to (a batch's lanes)."""
        return TopoDims(*(max(a, b) for a, b in zip(self, other)))


class TopoOperands(NamedTuple):
    """Per-fabric tables the step reads, as tensors on one device.

    Shapes: (P,) / (NSW,) / () with the dims of `TopoDims`. Ports, servers
    and switches padded beyond a fabric's real counts are inert phantoms
    (see `repro.sim.topology.TopoOperands` for the padding contract). A
    batch of K lanes (`sweep.stack_topos`) holds the K fabrics side by
    side: (K*P,) / (K*NSW,) with the batch's switch ids, and each scalar
    0-d when every lane agrees on it, else (K,)."""
    port_switch: torch.Tensor   # (P,) owning switch; -1 for NIC + phantom
    port_is_nic: torch.Tensor   # (P,) bool
    port_valid: torch.Tensor    # (P,) bool, False for phantom padding
    feeds: torch.Tensor         # (P,) switch fed by the port; -1 = a server
    switch_valid: torch.Tensor  # (NSW,) bool, False for phantom padding
    buffer_limit: torch.Tensor  # () i32 drop threshold (huge if infinite)
    occ_ref: torch.Tensor       # () i32 occupancy-histogram reference scale
    prop_ticks: torch.Tensor    # () i32 link delay = wire-ring wrap modulus


def pack_topo(topo: Topology, *, infinite_buffer: bool = False,
              dims: "TopoDims | None" = None,
              device="cuda") -> TopoOperands:
    """The operand bundle for `topo`, padded to `dims`, on `device`.

    `feeds[p]` is the switch whose buffer grows when port p transmits (PFC
    and buffer accounting): NIC -> its ToR, ToR up-port -> the spine, spine
    down-port -> the ToR; ToR down-ports feed servers (-1)."""
    dev = resolve_device(device)
    p0 = topo.params
    dims = dims or TopoDims.of(topo)
    P, NSW = dims.n_ports, dims.n_switches
    if P < topo.n_ports or NSW < topo.n_switches \
            or dims.n_servers < p0.n_servers \
            or dims.prop_max < p0.prop_ticks:
        raise ValueError(f"dims {dims} smaller than topology")

    port_switch = np.full(P, -1, np.int32)
    port_switch[:topo.n_ports] = topo.port_switch
    port_is_nic = np.zeros(P, bool)
    port_is_nic[:topo.n_ports] = topo.port_is_nic
    port_valid = np.zeros(P, bool)
    port_valid[:topo.n_ports] = True
    switch_valid = np.zeros(NSW, bool)
    switch_valid[:topo.n_switches] = True

    feeds = np.full(P, -1, np.int32)
    for s in range(p0.n_servers):
        feeds[s] = s // p0.servers_per_tor                    # NIC -> its ToR
    for tor in range(p0.n_tor):
        for sp in range(p0.n_spine):
            feeds[int(topo.tor_up_port(tor, sp))] = p0.n_tor + sp
        # ToR down-ports feed servers: stays -1
    for sp in range(p0.n_spine):
        for tor in range(p0.n_tor):
            feeds[int(topo.spine_down_port(sp, tor))] = tor

    buffer_limit = (1 << 29) if infinite_buffer else p0.switch_buffer_pkts

    def on(a):
        return torch.as_tensor(a).to(dev)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32).to(dev)

    return TopoOperands(
        port_switch=on(port_switch), port_is_nic=on(port_is_nic),
        port_valid=on(port_valid), feeds=on(feeds),
        switch_valid=on(switch_valid), buffer_limit=scalar(buffer_limit),
        occ_ref=scalar(p0.switch_buffer_pkts),
        prop_ticks=scalar(p0.prop_ticks))


def path_prop_ticks(routes: np.ndarray, prop_ticks: int) -> np.ndarray:
    """One-way propagation delay (ticks) of each flow's path."""
    hops = (routes >= 0).sum(axis=1)  # number of transmissions
    return hops * prop_ticks


def ideal_fct_ticks(routes: np.ndarray, size_pkts: np.ndarray,
                    prop_ticks: int) -> np.ndarray:
    """Best-possible FCT: store-and-forward pipeline at line rate on an idle
    network: size serialization + per-hop propagation."""
    return size_pkts + path_prop_ticks(routes, prop_ticks)
