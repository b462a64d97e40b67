"""Where a simulated tick's time goes on the card, eager and graphed.

    PYTHONPATH=src python -m repro_torch.sim.tick_profile [--ticks N]
        [--lanes K] [--repeat R]

Builds the paper-scale `bfc` case (`paper_case`, which `chip_smoke.py`
runs too: 128-server / 8 ToR / 8 spine Clos, fb_hadoop at load 0.6, seed 0,
4000 flows), or with `--lanes K` a sweep batch of K such cases (seeds 0 to
K-1, laid side by side as `sim.sweep` stacks them: one step, one graph and
one fused switch step launch per tick for all lanes), and profiles
`--ticks` ticks from tick `--start` (queues and
pause state populated) twice: stepped eagerly with `make_step`'s step, and
through the engine's runner, which replays a captured CUDA graph of
`engine.GRAPH_TICKS` ticks (`engine.TickGraph`). For each it prints, per
tick: wall time, device-busy time (the sum of the CUDA kernels' execution
intervals under `torch.profiler`), the device's idle share, the kernels
launched, and the kernels that take the most device time; then the
unprofiled time per tick from CUDA events around the window's successor,
and the host's time to issue that window (a host stall before the card
has work queued reads as idle there). `--repeat R` measures the graphed
window R more times, on the ticks that follow. When the profiler records
no kernels inside the graph's replays, the graphed tick is reported from
the CUDA events alone, and the output says so.
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
from . import engine, sweep, topology, workload
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
    events, host ms to issue the unprofiled run) of `run()`, which
    advances `n` ticks; called twice, on the same ticks' successors."""
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
    t0 = time.perf_counter()
    start.record()
    run()
    issue = time.perf_counter() - t0
    stop.record()
    torch.cuda.synchronize()
    return (kernel_events(prof), wall, start.elapsed_time(stop) / n,
            issue * 1e3)


def _unprofiled(kernels, n: int, ev_ms: float, issue_ms: float) -> None:
    """The unprofiled tick from CUDA events (kernels and the gaps between
    them), the profiled device-busy time's share of it, and the host's
    time to issue the unprofiled window."""
    busy = sum(us for _, us in kernels) / 1e3 / n
    print(f"  unprofiled (CUDA events): {ev_ms:.4f} ms per tick; device "
          f"busy (profiled) {busy:.4f} ms of it, idle share "
          f"{1 - busy / ev_ms:.4f}; window issued in {issue_ms:.2f} ms "
          f"host")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=256)
    ap.add_argument("--start", type=int, default=2048)
    ap.add_argument("--lanes", type=int, default=1)
    ap.add_argument("--repeat", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    k = engine.GRAPH_TICKS
    if args.start % k or args.ticks % k:
        ap.error(f"--start and --ticks must be multiples of {k}")

    K = args.lanes
    cases = [paper_case(seed) for seed in range(K)]
    _, topo, flows, cfg = cases[0]
    dims = topology.TopoDims.of(topo)
    fops = sweep.stack_operands([c[2] for c in cases], cfg, flows.n_flows,
                                dims, dev)
    tops = sweep.stack_topos([topo] * K, cfg, dims, dev)
    env, init_state, step = engine.make_step(dims, cfg, flows.n_flows, dev,
                                             K)
    n = args.ticks
    print(f"device={torch.cuda.get_device_name(0)} the paper-scale bfc "
          f"case, {K} lane(s) (seeds 0-{K - 1}), {n} ticks from tick "
          f"{args.start} profiled per runner")
    with torch.inference_mode():
        # eager: make_step's step, one Python call per tick
        box = [init_state()]

        def eager():
            for _ in range(n):
                box[0], _ = step(box[0], fops, tops)
        for _ in range(args.start):
            box[0], _ = step(box[0], fops, tops)
        kernels, wall, *ev = _window(eager, n)
        ok = print_breakdown("eager tick", kernels, n, wall)
        _unprofiled(kernels, n, *ev)

        # graphed: the engine's runner, GRAPH_TICKS ticks per replay
        emits = torch.zeros((args.start + 2 * (1 + args.repeat) * n,)
                            + env.lead
                            + (engine.emit_width(cfg, dims),),
                            dtype=torch.int32, device=dev)
        ticks = engine.TickGraph(step, init_state(), fops, tops, emits)
        ticks.advance(0, args.start)
        at = [args.start]

        def graphed():
            ticks.advance(at[0], n)
            at[0] += n
        for i in range(1 + args.repeat):
            kernels, wall, *ev = _window(graphed, n)
            what = f"graphed tick ({k} ticks per replay)" + (
                f", repeat {i}" if i else "")
            if not print_breakdown(what, kernels, n, wall):
                print(f"{what}: the profiler recorded no kernels in the "
                      f"replays; per tick wall {wall / n * 1e3:.3f} ms")
            _unprofiled(kernels, n, *ev)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
