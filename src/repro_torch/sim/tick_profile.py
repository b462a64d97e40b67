"""Where a simulated tick's time goes on the card.

    PYTHONPATH=src python -m repro_torch.sim.tick_profile [--ticks N]

Builds the paper-scale `bfc` case (`paper_case`, which `chip_smoke.py`
runs too: 128-server / 8 ToR / 8 spine Clos, fb_hadoop at load 0.6, seed 0,
4000 flows), steps it eagerly
to tick `--start` so that queues and pause state are populated, then runs
`--ticks` more ticks under `torch.profiler` and prints, per tick: wall
time, device-busy time (the sum of the CUDA kernels' execution
intervals), the device's idle share, the kernels launched, and the kernels
that take the most device time. Needs a CUDA device; exits non-zero when
the profiler records no device activity.
"""
from __future__ import annotations

import argparse
import sys
import time
from collections import Counter

import torch

from .. import resolve_device
from . import engine, topology, workload
from .config import PRESETS, SimConfig


TOP = 12    # kernels listed by device time


def kernel_events(prof):
    """(name, device µs) of every CUDA kernel the profiler recorded."""
    out = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            out.append((evt.name, evt.time_range.elapsed_us()))
    return out


def print_breakdown(what: str, kernels, n: int, wall: float) -> bool:
    """Print, per step of the `n` steps of `what` that took `wall` seconds:
    device-busy time (the sum of the `kernels`' execution intervals), the
    idle share against `wall`, the kernels launched, and the TOP kernels by
    device time. False, said on stderr, when there are no kernels."""
    if not kernels:
        print(f"the profiler recorded no CUDA kernels in {what}",
              file=sys.stderr)
        return False
    busy = sum(us for _, us in kernels) / 1e6
    print(f"{what}: per step wall {wall / n * 1e3:.3f} ms, device busy "
          f"{busy / n * 1e3:.3f} ms, idle share {1 - busy / wall:.4f}, "
          f"{len(kernels) / n:.1f} kernels")
    by_name, count = Counter(), Counter()
    for name, us in kernels:
        by_name[name] += us
        count[name] += 1
    print(f"  top {TOP} kernels by device time (ms per step, share of busy, "
          "launches per step):")
    for name, us in by_name.most_common(TOP):
        print(f"  {us / n / 1e3:9.4f}  {us / 1e6 / busy:6.3f}  "
              f"{count[name] / n:7.2f}  {name[:90]}")
    return True


def paper_case(seed: int = 0):
    """(clos, topo, flows, cfg) of the paper-scale `bfc` case: the paper's
    128-server / 8 ToR / 8 spine Clos, fb_hadoop at load 0.6, 4000 flows."""
    clos = topology.ClosParams(n_servers=128, n_tor=8, n_spine=8)
    topo = topology.build(clos)
    flows = workload.generate(
        topo, workload.WorkloadParams(workload="fb_hadoop", load=0.6,
                                      seed=seed), 4000)
    return clos, topo, flows, SimConfig(proto=PRESETS["bfc"], clos=clos)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=256)
    ap.add_argument("--start", type=int, default=2048)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")

    _, topo, flows, cfg = paper_case()
    fops = engine.pack_flows(flows, cfg, dev)
    tops = topology.pack_topo(topo, device=dev)
    _, init_state, step = engine.make_step(topology.TopoDims.of(topo), cfg,
                                           flows.n_flows, dev)
    with torch.inference_mode():
        st = init_state()
        for _ in range(args.start):
            st, _ = step(st, fops, tops)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.ticks):
                st, _ = step(st, fops, tops)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0

    print(f"device={torch.cuda.get_device_name(0)} the paper-scale bfc "
          f"case, ticks [{args.start}, {args.start + args.ticks}) profiled")
    return 0 if print_breakdown("tick", kernel_events(prof), args.ticks,
                                wall) else 1


if __name__ == "__main__":
    sys.exit(main())
