"""Workload synthesis (paper §4.1, Fig. 2): torch port of
`repro.sim.workload`.

Host-side numpy, drawing from `np.random.default_rng(seed)` exactly as the
reference does, so the same `WorkloadParams` yield the same `FlowSet`
arrays. The ECMP spine choice hashes through the port's own
`core.hashing` (on the CPU). Also holds `pad_flowset`, the phantom-flow
padding of `repro.sim.sweep.pad_flowset`.

Flow sizes are drawn from piecewise log-linear CDFs matching the three
industry workloads in Fig. 2; arrivals are lognormal inter-arrival times
(sigma = 2) scaled so the offered load on the oversubscribed core equals
the target; incast events are synchronized N-to-1 transfers.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.hashing import ecmp_choice
from .topology import MAX_HOPS, Topology, ideal_fct_ticks, routes_for_flows

# Arrival tick of padded "phantom" flows: beyond any simulated horizon, so
# they never start, never transmit, never allocate.
PHANTOM_ARRIVAL = int(1 << 30)

# (size_in_KB, CDF-by-*count*) control points. Derived from the published
# byte-weighted CDFs; interpolation is log-linear in size.
_SIZE_CDFS = {
    # Google all-apps: many tiny RPCs, tail to 100 MB
    "google": [(1, 0.35), (2, 0.45), (4, 0.55), (8, 0.62), (16, 0.70),
               (32, 0.77), (64, 0.83), (128, 0.88), (256, 0.92), (512, 0.95),
               (1024, 0.97), (4096, 0.988), (16384, 0.996), (65536, 1.0)],
    # FB Hadoop: dominated by small flows by count; bytes in 0.1-10 MB
    "fb_hadoop": [(1, 0.50), (2, 0.62), (4, 0.70), (8, 0.75), (16, 0.79),
                  (32, 0.83), (64, 0.87), (128, 0.91), (256, 0.94),
                  (512, 0.96), (1024, 0.975), (2048, 0.985), (4096, 0.992),
                  (10240, 1.0)],
    # DCTCP WebSearch
    "websearch": [(1, 0.15), (4, 0.30), (16, 0.45), (64, 0.60), (256, 0.75),
                  (1024, 0.87), (4096, 0.95), (10240, 0.98), (30720, 1.0)],
    # Uniform small-flow debug workload
    "uniform": [(1, 0.0), (64, 1.0)],
}


@dataclass(frozen=True)
class WorkloadParams:
    workload: str = "fb_hadoop"
    load: float = 0.6              # offered load on the oversubscribed core
    incast_load: float = 0.0       # e.g. 0.05 -> "5% incast traffic"
    incast_degree: int = 100       # N-to-1
    incast_total_kb: int = 20480   # 20 MB aggregate per incast event
    locality: float = 0.0          # P(dst in same rack), App. B
    sigma: float = 2.0             # lognormal inter-arrival sigma
    mtu_kb: int = 1
    seed: int = 0


@dataclass
class FlowSet:
    """Static per-flow metadata (host numpy)."""
    src: np.ndarray            # (F,) server id
    dst: np.ndarray            # (F,)
    size_pkts: np.ndarray      # (F,)
    arrival_tick: np.ndarray   # (F,)
    routes: np.ndarray         # (F, MAX_HOPS) egress port ids
    ideal_fct: np.ndarray      # (F,) ticks
    fid: np.ndarray            # (F,) 32-bit flow ids (for hashing)
    is_incast: np.ndarray      # (F,) bool
    horizon: int = 0           # last arrival tick (for load accounting)

    @property
    def n_flows(self) -> int:
        return len(self.src)


def sample_sizes(rng: np.random.Generator, n: int, workload: str,
                 mtu_kb: int = 1) -> np.ndarray:
    pts = _SIZE_CDFS[workload]
    sizes_kb = np.array([p[0] for p in pts], float)
    cdf = np.array([p[1] for p in pts], float)
    u = rng.random(n)
    # log-linear interpolation of the inverse CDF; below the first point ->
    # first size.
    logs = np.interp(u, np.concatenate([[0.0], cdf]),
                     np.concatenate([[np.log(sizes_kb[0])], np.log(sizes_kb)]))
    kb = np.exp(logs)
    return np.maximum(1, np.round(kb / mtu_kb)).astype(np.int32)


def mean_size_pkts(workload: str, mtu_kb: int = 1, n: int = 200_000,
                   seed: int = 1234) -> float:
    rng = np.random.default_rng(seed)
    return float(sample_sizes(rng, n, workload, mtu_kb).mean())


def generate(topo: Topology, wp: WorkloadParams, n_flows: int,
             long_lived: int = 0, long_lived_pkts: int = 1 << 30) -> FlowSet:
    """Generate `n_flows` background flows (+ optional incast + long-lived).

    Load calibration: the core (ToR<->spine) carries the inter-rack fraction
    of traffic over n_tor*n_spine links; the mean inter-arrival is scaled so
    that offered core load matches wp.load (paper's definition, §4 fn.4).
    """
    rng = np.random.default_rng(wp.seed)
    p = topo.params

    sizes = sample_sizes(rng, n_flows, wp.workload, wp.mtu_kb)

    inter_frac = (1.0 - wp.locality) * (1.0 - 1.0 / p.n_tor) + 0.0
    core_links = p.n_tor * p.n_spine
    target_core_pkts_per_tick = wp.load * core_links
    mean_size = float(sizes.mean())
    # flows/tick so that inter-rack bytes/tick hits the target
    lam = target_core_pkts_per_tick / (mean_size * max(inter_frac, 1e-6))

    # lognormal inter-arrivals with mean 1/lam, sigma=2 (heavy burst trains)
    sig = wp.sigma
    mu_ln = np.log(1.0 / lam) - 0.5 * sig * sig
    inter = rng.lognormal(mean=mu_ln, sigma=sig, size=n_flows)
    arrivals = np.cumsum(inter)
    arrivals = np.floor(arrivals).astype(np.int64)

    src = rng.integers(0, p.n_servers, n_flows)
    # destination: rack-local with prob locality, else uniform over others
    dst = rng.integers(0, p.n_servers, n_flows)
    same = dst == src
    dst[same] = (dst[same] + 1 + rng.integers(0, p.n_servers - 1, same.sum())) \
        % p.n_servers
    if wp.locality > 0:
        local = rng.random(n_flows) < wp.locality
        rack = src // p.servers_per_tor
        off = rng.integers(1, p.servers_per_tor, local.sum())
        dst[local] = rack[local] * p.servers_per_tor + \
            (src[local] % p.servers_per_tor + off) % p.servers_per_tor

    is_incast = np.zeros(n_flows, bool)
    horizon = int(arrivals.max()) if n_flows else 0

    # ---- incast injection ---------------------------------------------------
    if wp.incast_load > 0:
        per_flow_kb = max(1, wp.incast_total_kb // wp.incast_degree)
        per_event_pkts = wp.incast_degree * (per_flow_kb // wp.mtu_kb)
        # events/tick to consume incast_load of core capacity
        ev_rate = wp.incast_load * core_links / max(per_event_pkts, 1)
        n_events = max(1, int(np.floor(horizon * ev_rate)))
        ev_ticks = np.sort(rng.integers(0, max(horizon, 1), n_events))
        inc_src, inc_dst, inc_arr = [], [], []
        for t in ev_ticks:
            victim = int(rng.integers(0, p.n_servers))
            senders = rng.choice(
                np.setdiff1d(np.arange(p.n_servers), [victim]),
                size=min(wp.incast_degree, p.n_servers - 1), replace=False)
            inc_src.append(senders)
            inc_dst.append(np.full(len(senders), victim))
            inc_arr.append(np.full(len(senders), t))
        inc_src = np.concatenate(inc_src); inc_dst = np.concatenate(inc_dst)
        inc_arr = np.concatenate(inc_arr)
        inc_size = np.full(len(inc_src), per_flow_kb // wp.mtu_kb, np.int32)
        src = np.concatenate([src, inc_src])
        dst = np.concatenate([dst, inc_dst])
        sizes = np.concatenate([sizes, inc_size])
        arrivals = np.concatenate([arrivals, inc_arr])
        is_incast = np.concatenate([is_incast, np.ones(len(inc_src), bool)])

    # ---- long-lived flows (Table 1 / Fig. 5 experiments) --------------------
    if long_lived > 0:
        ll_src = rng.integers(0, p.n_servers, long_lived)
        ll_dst = (ll_src + p.servers_per_tor) % p.n_servers  # force inter-rack
        src = np.concatenate([src, ll_src])
        dst = np.concatenate([dst, ll_dst])
        sizes = np.concatenate([sizes,
                                np.full(long_lived, long_lived_pkts, np.int64)])
        arrivals = np.concatenate([arrivals, np.zeros(long_lived, np.int64)])
        is_incast = np.concatenate([is_incast, np.zeros(long_lived, bool)])

    order = np.argsort(arrivals, kind="stable")
    src, dst = src[order], dst[order]
    sizes, arrivals, is_incast = sizes[order], arrivals[order], is_incast[order]

    fid = (np.arange(len(src), dtype=np.int64) * 2654435761 + wp.seed * 97 + 1) \
        % (1 << 31)
    fid = fid.astype(np.int32)
    spine = ecmp_choice(torch.from_numpy(fid), p.n_spine).numpy()
    routes = routes_for_flows(topo, src, dst, spine)
    ideal = ideal_fct_ticks(routes, sizes.astype(np.int64), p.prop_ticks)

    return FlowSet(src=src.astype(np.int32), dst=dst.astype(np.int32),
                   size_pkts=sizes.astype(np.int32),
                   arrival_tick=arrivals.astype(np.int32), routes=routes,
                   ideal_fct=ideal.astype(np.int32), fid=fid,
                   is_incast=is_incast, horizon=horizon)


def pad_flowset(flows: FlowSet, f_max: int) -> FlowSet:
    """Append inert phantom flows until the set holds `f_max` flows:
    arrival `PHANTOM_ARRIVAL`, size 0, routes all -1 (never started, never
    looked up by any hop)."""
    pad = f_max - flows.n_flows
    if pad < 0:
        raise ValueError(f"f_max={f_max} < n_flows={flows.n_flows}")
    if pad == 0:
        return flows
    return FlowSet(
        src=np.concatenate([np.asarray(flows.src, np.int32),
                            np.zeros(pad, np.int32)]),
        dst=np.concatenate([np.asarray(flows.dst, np.int32),
                            np.zeros(pad, np.int32)]),
        size_pkts=np.concatenate([np.asarray(flows.size_pkts, np.int32),
                                  np.zeros(pad, np.int32)]),
        arrival_tick=np.concatenate(
            [np.asarray(flows.arrival_tick, np.int32),
             np.full(pad, PHANTOM_ARRIVAL, np.int32)]),
        routes=np.concatenate([np.asarray(flows.routes, np.int32),
                               np.full((pad, MAX_HOPS), -1, np.int32)]),
        ideal_fct=np.concatenate([np.asarray(flows.ideal_fct, np.int32),
                                  np.ones(pad, np.int32)]),
        fid=np.concatenate([np.asarray(flows.fid, np.int32),
                            np.zeros(pad, np.int32)]),
        is_incast=np.concatenate([np.asarray(flows.is_incast, bool),
                                  np.zeros(pad, bool)]),
        horizon=flows.horizon)
