"""Post-processing of simulator runs into the paper's metrics (torch port
of `repro.sim.metrics`: `RunMetrics` and `summarize`, host numpy).

FCT slowdown percentiles by flow-size bin (Figs. 9-12), buffer-occupancy
percentiles, PFC pause fraction and the event counters of one run.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from .workload import FlowSet

# flow size bin edges in packets (1 KB MTU), used for slowdown-vs-size plots
SIZE_BINS_KB = [1, 3, 10, 30, 100, 300, 1000, 3000, 10000, 30000, 1 << 30]


@dataclass
class RunMetrics:
    name: str
    completed: int
    total: int
    fct_slowdown_avg: float
    fct_slowdown_p50: float
    fct_slowdown_p95: float
    fct_slowdown_p99: float
    by_size: Dict[str, Dict[str, float]]
    buffer_p99_pkts: float
    buffer_max_pkts: int
    pfc_pause_frac: float
    drops: int
    collisions: int
    allocs: int
    overflow: int
    pauses: int
    distance_from_optimal: Optional[float] = None
    slowdowns: np.ndarray = field(repr=False, default=None)
    sizes: np.ndarray = field(repr=False, default=None)
    occ_hist: np.ndarray = field(repr=False, default=None)
    qlen_hist: np.ndarray = field(repr=False, default=None)
    flows_hist: np.ndarray = field(repr=False, default=None)


def _pct(x: np.ndarray, q: float) -> float:
    return float(np.percentile(x, q)) if len(x) else float("nan")


def summarize(name: str, state, emits: np.ndarray, flows: FlowSet,
              n_links: int, occ_bin_ref: int, cap: int,
              exclude: Optional[np.ndarray] = None,
              incast_only: bool = False) -> RunMetrics:
    """Metrics of one run from its host-side state (numpy leaves, as
    `engine.run` returns them) and emit rows."""
    done = np.asarray(state.done)
    mask = done >= 0
    if exclude is not None:
        mask &= ~exclude
    if incast_only:
        mask &= flows.is_incast
    else:
        mask &= ~flows.is_incast
    fct = (done - flows.arrival_tick).astype(np.float64)
    slow = fct / np.maximum(flows.ideal_fct, 1)
    s = slow[mask]
    sizes = flows.size_pkts[mask]

    by_size = {}
    lo = 0
    for hi in SIZE_BINS_KB:
        sel = (sizes > lo) & (sizes <= hi)
        if sel.sum() > 0:
            key = f"({lo},{hi}]KB"
            by_size[key] = {
                "n": int(sel.sum()),
                "avg": float(s[sel].mean()),
                "p95": _pct(s[sel], 95),
                "p99": _pct(s[sel], 99),
            }
        lo = hi

    # buffer occupancy percentiles from the max-over-switches time series
    occ_series = emits[:, 0]
    pfc_series = emits[:, 1]

    return RunMetrics(
        name=name,
        completed=int(mask.sum()),
        total=int((~flows.is_incast).sum() if not incast_only
                  else flows.is_incast.sum()),
        fct_slowdown_avg=float(s.mean()) if len(s) else float("nan"),
        fct_slowdown_p50=_pct(s, 50),
        fct_slowdown_p95=_pct(s, 95),
        fct_slowdown_p99=_pct(s, 99),
        by_size=by_size,
        buffer_p99_pkts=_pct(occ_series, 99),
        buffer_max_pkts=int(occ_series.max()) if len(occ_series) else 0,
        pfc_pause_frac=float(pfc_series.sum())
        / max(len(pfc_series) * n_links, 1),
        drops=int(state.stat_drops),
        collisions=int(state.stat_collisions),
        allocs=int(state.stat_allocs),
        overflow=int(state.stat_overflow),
        pauses=int(state.stat_pauses),
        slowdowns=s, sizes=sizes,
        occ_hist=np.asarray(state.occ_hist),
        qlen_hist=np.asarray(state.qlen_hist),
        flows_hist=np.asarray(state.flows_hist),
    )
