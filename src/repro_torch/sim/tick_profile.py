"""Where a simulated tick's time goes on the card, eager and graphed.

    PYTHONPATH=src python -m repro_torch.sim.tick_profile [--ticks N]

Builds the paper-scale `bfc` case (`paper_case`, which `chip_smoke.py`
runs too: 128-server / 8 ToR / 8 spine Clos, fb_hadoop at load 0.6, seed 0,
4000 flows) and profiles `--ticks` ticks from tick `--start` (queues and
pause state populated) twice: stepped eagerly with `make_step`'s step, and
through the engine's runner, which replays a captured CUDA graph of
`engine.GRAPH_TICKS` ticks (`engine.TickGraph`). For each it prints, per
tick: wall time, device-busy time (the sum of the CUDA kernels' execution
intervals under `torch.profiler`), the device's idle share, the kernels
launched, and the kernels that take the most device time; then the
unprofiled time per tick from CUDA events around the same window. When
the profiler records no kernels inside the graph's replays, the graphed
tick is reported from the CUDA events alone, and the output says so.
Needs a CUDA device; exits non-zero when the profiler records no device
activity in the eager ticks.
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


def _window(run, n: int):
    """(kernels, profiled wall s, unprofiled device ms per tick from CUDA
    events) of `run()`, which advances `n` ticks; called twice, on the
    same ticks' successors."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    return kernel_events(prof), wall, start.elapsed_time(stop) / n


def _unprofiled(kernels, n: int, ev_ms: float) -> None:
    """The unprofiled tick from CUDA events (kernels and the gaps between
    them), and the profiled device-busy time's share of it."""
    busy = sum(us for _, us in kernels) / 1e3 / n
    print(f"  unprofiled (CUDA events): {ev_ms:.4f} ms per tick; device "
          f"busy (profiled) {busy:.4f} ms of it, idle share "
          f"{1 - busy / ev_ms:.4f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=256)
    ap.add_argument("--start", type=int, default=2048)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    k = engine.GRAPH_TICKS
    if args.start % k or args.ticks % k:
        ap.error(f"--start and --ticks must be multiples of {k}")

    _, topo, flows, cfg = paper_case()
    dims = topology.TopoDims.of(topo)
    fops = engine.pack_flows(flows, cfg, dev)
    tops = topology.pack_topo(topo, device=dev)
    env, init_state, step = engine.make_step(dims, cfg, flows.n_flows, dev)
    n = args.ticks
    print(f"device={torch.cuda.get_device_name(0)} the paper-scale bfc "
          f"case, {n} ticks from tick {args.start} profiled per runner")
    with torch.inference_mode():
        # eager: make_step's step, one Python call per tick
        box = [init_state()]

        def eager():
            for _ in range(n):
                box[0], _ = step(box[0], fops, tops)
        for _ in range(args.start):
            box[0], _ = step(box[0], fops, tops)
        kernels, wall, ev = _window(eager, n)
        ok = print_breakdown("eager tick", kernels, n, wall)
        _unprofiled(kernels, n, ev)

        # graphed: the engine's runner, GRAPH_TICKS ticks per replay
        emits = torch.zeros((args.start + 3 * n,
                             engine.emit_width(cfg, dims)),
                            dtype=torch.int32, device=dev)
        ticks = engine.TickGraph(step, init_state(), fops, tops, emits)
        ticks.advance(0, args.start)
        at = [args.start]

        def graphed():
            ticks.advance(at[0], n)
            at[0] += n
        kernels, wall, ev = _window(graphed, n)
        if not print_breakdown(f"graphed tick ({k} ticks per replay)",
                               kernels, n, wall):
            print(f"graphed tick ({k} ticks per replay): the profiler "
                  f"recorded no kernels in the replays; per tick wall "
                  f"{wall / n * 1e3:.3f} ms")
        _unprofiled(kernels, n, ev)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
