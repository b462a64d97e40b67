"""The golden-trace case, held against the committed fixtures.

`tests/fixtures/traces/<family>.npz` holds, for every `config.PRESETS`
family, the full-channel per-tick trace of one pinned micro-case, written
by the JAX package (`repro.sim.trace.golden`). This module keeps the port's
own copy of that pinned case (fabric, workload, trace spec, horizon),
checks that a fixture's recorded `meta` matches the copy, reruns a family
through `engine.simulate` on any device, and compares emits, trace
channels and `active_ticks` bit for bit. Plain numpy file IO: it needs no
JAX to read the fixtures.
"""
from __future__ import annotations

import json
from dataclasses import asdict
from pathlib import Path
from typing import List

import numpy as np

from .. import engine, topology, workload
from ..config import PRESETS, SimConfig
from .spec import EMIT_BASE, TraceSpec, layout

FIXTURE_VERSION = 1
GOLDEN_N_FLOWS = 24
GOLDEN_N_TICKS = 2048
GOLDEN_SPEC = TraceSpec.full()
# the fixtures were spooled from one lane of a batch padded to 64 flows
GOLDEN_PAD_FLOWS = 64

# repo-committed fixture directory (tests/fixtures/traces/ from repo root)
FIXTURE_DIR = (Path(__file__).resolve().parents[4]
               / "tests" / "fixtures" / "traces")


def golden_clos() -> topology.ClosParams:
    return topology.ClosParams(n_servers=8, n_tor=2, n_spine=2,
                               switch_buffer_pkts=512)


def golden_wp() -> workload.WorkloadParams:
    # mild incast rides on the uniform background so pause-plane channels
    # (PFC, SFC source signals) are exercised, not identically zero
    return workload.WorkloadParams(workload="uniform", load=0.6, seed=11,
                                   incast_load=0.15, incast_degree=6,
                                   incast_total_kb=1024)


def golden_case():
    """(topo, flows) of the pinned micro-case (flows not yet padded)."""
    topo = topology.build(golden_clos())
    return topo, workload.generate(topo, golden_wp(), GOLDEN_N_FLOWS)


def golden_cfg(proto) -> SimConfig:
    return SimConfig(proto=proto, clos=golden_clos(), probe_flow=0,
                     trace=GOLDEN_SPEC)


def pinned_meta() -> dict:
    """The pin a fixture's recorded meta must equal."""
    topo, _ = golden_case()
    dims = topology.TopoDims.of(topo)
    return {
        "version": FIXTURE_VERSION,
        "clos": asdict(golden_clos()),
        "workload": asdict(golden_wp()),
        "n_flows": GOLDEN_N_FLOWS,
        "n_ticks": GOLDEN_N_TICKS,
        "trace": GOLDEN_SPEC.describe(),
        "layout": layout(GOLDEN_SPEC, dims.n_ports, dims.n_switches).meta(),
    }


def load_fixture(name: str) -> dict:
    with np.load(FIXTURE_DIR / f"{name}.npz") as z:
        return {"trace": np.asarray(z["trace"]),
                "emits": np.asarray(z["emits"]),
                "active_ticks": np.asarray(z["active_ticks"]),
                "meta": json.loads(str(z["meta"]))}


def run_family(name: str, device) -> dict:
    """Run one PRESETS family on the pinned case on `device`: host numpy
    emits (T, 3), trace (T, C) and the active tick count."""
    topo, flows = golden_case()
    flows = workload.pad_flowset(flows, GOLDEN_PAD_FLOWS)
    cfg = golden_cfg(PRESETS[name])
    _, emits, active = engine.simulate(
        topology.TopoDims.of(topo), cfg,
        engine.pack_flows(flows, cfg, device),
        topology.pack_topo(topo, infinite_buffer=cfg.proto.infinite_buffer,
                           device=device),
        GOLDEN_N_TICKS)
    emits = emits.cpu().numpy()
    return {"emits": emits[:, :EMIT_BASE], "trace": emits[:, EMIT_BASE:],
            "active_ticks": int(active)}


def compare(name: str, out: dict) -> List[str]:
    """Problems that keep `out` (from `run_family`) from reproducing the
    committed fixture of `name` bit for bit; empty when it does."""
    fx = load_fixture(name)
    problems = []
    if fx["meta"] != pinned_meta():
        drift = [k for k in fx["meta"] if fx["meta"][k] != pinned_meta()[k]]
        problems.append(f"{name}: fixture meta differs from the port's "
                        f"pinned case in {drift}")
    for key in ("emits", "trace"):
        want, got = fx[key][0], out[key]
        if want.shape != got.shape:
            problems.append(f"{name}: {key} shape {got.shape} != "
                            f"{want.shape}")
            continue
        bad = np.argwhere(want != got)
        if bad.size:
            tick, col = (int(i) for i in bad[0])
            problems.append(f"{name}: {key} first differs at tick {tick} "
                            f"column {col}: {got[tick, col]} != "
                            f"{want[tick, col]}")
    if int(fx["active_ticks"][0]) != out["active_ticks"]:
        problems.append(f"{name}: active_ticks {out['active_ticks']} != "
                        f"{int(fx['active_ticks'][0])}")
    return problems
