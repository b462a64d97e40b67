#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of the BFC simulator on one GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in order (any failure exits non-zero; no phase catches its own):

1. setup     -- device, torch version, `nvidia-smi` name and power limit;
                build the CUDA kernels from `src/repro_torch/.../csrc`.
2. kernels   -- `bfc_fused` (DRR and SRF) and `bfc_decide` against their
                plain torch versions on the card, exact equality of every
                output; CUDA-event timings of kernel, plain version and the
                memory/operation bound at the main path's shape.
3. golden    -- all 16 PRESETS families on the pinned golden case, emits,
                trace channels and active ticks bit-for-bit against
                `tests/fixtures/traces/<family>.npz`.
4. paper     -- `bfc` on the paper's 128-server / 8 ToR / 8 spine Clos,
                fb_hadoop at load 0.6, seed 0, 4000 flows, horizon + 20000
                ticks: wall time, ticks/s, FCT slowdown, drops, and the
                `bfc_fused` launch count, which must equal the simulated
                ticks.
5. report    -- one `kernels` JSON line, then the device JSON line last.

Imports nothing of JAX and nothing of the JAX package. Exits non-zero
without a result when CUDA is unavailable or the port is not beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
# (P, Q) shapes at which every kernel is held against its plain version
FUSED_SHAPES = [(384, 32), (384, 1), (384, 64), (97, 32), (24, 32)]
DECIDE_SHAPES = [(384, 32), (8, 1025)]
MAIN_SHAPE = (384, 32)            # the paper-scale bfc path's (P, Q)
PAUSE_WINDOW = 37                 # TimingParams().pause_window
TIMED_LAUNCHES = 2000
GRAPH_CALLS = 200
# H100 SXM: HBM bytes/s (NVIDIA data sheet), and the INT32 rate for the
# kernels' integer operations: an SM has half as many INT32 as FP32 lanes,
# so half the data sheet's 67e12 non-tensor FP32 rate
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
# integer operations per (port, queue) element of one call, counted from
# csrc/bfc_step.cu: activity test (3), count (1), DRR key (4), packed key
# (2), running min (1), pause compare (1), occ_after update (2)
OPS_PER_ELEMENT = 14
PAPER_DRAIN = 20_000
GOLDEN_WORKERS = 4


def say(*parts) -> None:
    print(*parts, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def kernel_inputs(torch, rng, p, q, *, srf=False):
    """Seeded inputs with some rows all-paused, empty or blocked."""
    from repro_torch.kernels.bfc_step.ref import BIG
    band = max(1, p // 16)
    occ = rng.integers(0, 40, (p, q)).astype(np.int32)
    occ[band:2 * band] = 0                            # empty rows
    qpaused = rng.random((p, q)) < 0.3
    qpaused[:band] = True                             # all-paused rows
    ptr = rng.integers(0, q, p).astype(np.int32)
    blocked = rng.random(p) < 0.2
    blocked[-band:] = True                            # blocked rows
    key = rng.integers(0, BIG + 1, (p, q)).astype(np.int32) if srf else None

    def dev(a):
        return None if a is None else torch.from_numpy(a).cuda()
    return dev(occ), dev(qpaused), dev(ptr), dev(blocked), dev(key)


def max_abs_err(torch, got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"output shape/dtype {g.shape}/{g.dtype} "
                                 f"!= {w.shape}/{w.dtype}")
        err = max(err, int((g.long() - w.long()).abs().max()) if g.numel()
                  else 0)
    return err


def _events(torch, run, per_run: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / per_run


def time_ms(torch, fn, n=TIMED_LAUNCHES) -> float:
    """ms per call issued eagerly from Python, back to back: includes the
    host's dispatch of every call (the cost a tick of the engine pays)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(n):
            fn()
    return _events(torch, run, n)


def device_ms(torch, fn, n=GRAPH_CALLS, replays=10) -> float:
    """ms of device time per call: `n` calls captured once in a CUDA graph
    (timing only; the engine runs eagerly), then replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()

    def run():
        for _ in range(replays):
            graph.replay()
    return _events(torch, run, n * replays)


def bound(p, q, *, fused, srf=False):
    """(bound_ms, bound_by): each input read once, each output written
    once, over HBM bandwidth; integer operations over the INT32 peak."""
    n_in = p * q * (4 + 1) + p * 4 + (p * 1 if fused else 0) \
        + (p * q * 4 if srf else 0)
    n_out = p * 4 * 3 + p * q * 1 + ((p * 1 + p * q * 4) if fused else 0)
    t_bytes = (n_in + n_out) / HBM_BYTES_PER_S * 1e3
    t_ops = p * q * OPS_PER_ELEMENT / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch):
    from repro_torch.kernels.bfc_step import bfc_step, ref
    rng = np.random.default_rng(SEED)
    worst = {"bfc_fused": 0, "bfc_decide": 0}
    for sched in ("drr", "srf"):
        for p, q in FUSED_SHAPES:
            occ, qp, ptr, blk, key = kernel_inputs(torch, rng, p, q,
                                                   srf=sched == "srf")
            args = dict(pause_window=PAUSE_WINDOW, scheduler=sched,
                        srf_key=key)
            got = bfc_step.bfc_fused(occ, qp, ptr, blk, **args)
            want = ref.bfc_fused_ref(occ, qp, ptr, blk, **args)
            torch.cuda.synchronize()
            err = max_abs_err(torch, got, want)
            say(f"[kernels] bfc_fused {sched} P={p} Q={q} max_abs_err={err}")
            if err:
                raise AssertionError(f"bfc_fused {sched} ({p},{q}) differs "
                                     "from its plain version")
            worst["bfc_fused"] = max(worst["bfc_fused"], err)
    # nothing eligible anywhere: sel -1, can_tx false, occ unchanged
    occ = torch.full((16, 8), 5, dtype=torch.int32, device="cuda")
    qp = torch.zeros((16, 8), dtype=torch.bool, device="cuda")
    ptr = torch.zeros((16,), dtype=torch.int32, device="cuda")
    blk = torch.ones((16,), dtype=torch.bool, device="cuda")
    got = bfc_step.bfc_fused(occ, qp, ptr, blk, pause_window=PAUSE_WINDOW)
    want = ref.bfc_fused_ref(occ, qp, ptr, blk, pause_window=PAUSE_WINDOW)
    if max_abs_err(torch, got, want) or bool(got[4].any()):
        raise AssertionError("bfc_fused all-blocked case differs")
    for p, q in DECIDE_SHAPES:
        occ, qp, ptr, _, _ = kernel_inputs(torch, rng, p, q)
        if q == 1025:   # the packed-sentinel regression case
            occ = torch.zeros_like(occ)
            occ[:, q - 1] = 3
            qp = torch.zeros_like(qp)
            ptr = torch.zeros_like(ptr)
        got = bfc_step.bfc_decide(occ, qp, ptr, pause_window=PAUSE_WINDOW)
        want = ref.bfc_decide_ref(occ, qp, ptr, pause_window=PAUSE_WINDOW)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        say(f"[kernels] bfc_decide P={p} Q={q} max_abs_err={err}")
        if err or (q == 1025 and got[3].tolist() != [q - 1] * p):
            raise AssertionError(f"bfc_decide ({p},{q}) differs")
        worst["bfc_decide"] = max(worst["bfc_decide"], err)

    # timings at the main path's shape (DRR, as `bfc` runs it)
    p, q = MAIN_SHAPE
    occ, qp, ptr, blk, key = kernel_inputs(torch, rng, p, q, srf=True)
    fused_args = dict(pause_window=PAUSE_WINDOW)
    timing = {}
    for name, kern, plain, fused in (
            ("bfc_fused",
             lambda: bfc_step.bfc_fused(occ, qp, ptr, blk, **fused_args),
             lambda: ref.bfc_fused_ref(occ, qp, ptr, blk, **fused_args),
             True),
            ("bfc_decide",
             lambda: bfc_step.bfc_decide(occ, qp, ptr,
                                         pause_window=PAUSE_WINDOW),
             lambda: ref.bfc_decide_ref(occ, qp, ptr,
                                        pause_window=PAUSE_WINDOW),
             False)):
        host = {"plain": time_ms(torch, plain), "kernel": time_ms(torch, kern)}
        # in turns: plain, kernel, kernel, plain
        dev = {"plain": [device_ms(torch, plain)]}
        dev["kernel"] = [device_ms(torch, kern), device_ms(torch, kern)]
        dev["plain"].append(device_ms(torch, plain))
        b_ms, b_by = bound(p, q, fused=fused)
        timing[name] = {"ms": min(dev["kernel"]),
                        "plain_ms": min(dev["plain"]),
                        "bound_ms": b_ms, "bound_by": b_by}
        say(f"[kernels] time {name} P={p} Q={q} per call: device "
            f"(CUDA graph of {GRAPH_CALLS} calls, CUDA events) kernel "
            + "/".join(f"{v * 1e3:.3f}" for v in dev["kernel"])
            + " us, plain " + "/".join(f"{v * 1e3:.3f}" for v in dev["plain"])
            + f" us; issued eagerly from Python ({TIMED_LAUNCHES} calls) "
            f"kernel {host['kernel'] * 1e3:.3f} us, plain "
            f"{host['plain'] * 1e3:.3f} us; bound {b_ms * 1e3:.4f} us "
            f"({b_by})")
    srf = device_ms(torch, lambda: bfc_step.bfc_fused(
        occ, qp, ptr, blk, pause_window=PAUSE_WINDOW, scheduler="srf",
        srf_key=key))
    say(f"[kernels] time bfc_fused srf P={p} Q={q} per call: device "
        f"{srf * 1e3:.3f} us, bound "
        f"{bound(p, q, fused=True, srf=True)[0] * 1e3:.4f} us")
    return worst, timing


def _golden_worker(names):
    """Run golden families in a worker process on the card; returns one
    (name, active_ticks, bfc_fused launches, wall s, problems) each."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.bfc_step import ops
    from repro_torch.sim.trace import golden
    out = []
    for name in names:
        ops.reset_launches()
        t0 = time.perf_counter()
        res = golden.run_family(name, "cuda")
        out.append((name, res["active_ticks"], ops.launches["bfc_fused"],
                    time.perf_counter() - t0, golden.compare(name, res)))
    return out


def phase_golden(torch):
    """The 16 families are host-bound Python loops, so they run in
    GOLDEN_WORKERS processes side by side on the one card."""
    import multiprocessing as mp
    from repro_torch.sim.config import PRESETS
    names = sorted(PRESETS)
    chunks = [names[i::GOLDEN_WORKERS] for i in range(GOLDEN_WORKERS)]
    t0 = time.perf_counter()
    pool = mp.get_context("spawn").Pool(GOLDEN_WORKERS)
    try:
        results = [r for chunk in pool.map(_golden_worker, chunks)
                   for r in chunk]
        pool.close()
    finally:
        pool.terminate()
        pool.join()
    problems = []
    for name, active, launches, wall, found in sorted(results):
        problems += found
        say(f"[golden] {name}: active_ticks={active} bfc_fused "
            f"launches={launches} wall={wall:.2f}s "
            f"{'OK' if not found else found}")
    say(f"[golden] {len(results)} families in {GOLDEN_WORKERS} processes: "
        f"{time.perf_counter() - t0:.2f}s")
    if len(results) != len(names) or problems:
        raise AssertionError("golden traces differ:\n" + "\n".join(problems))


def phase_paper(torch):
    from repro_torch.kernels.bfc_step import ops
    from repro_torch.sim import engine, metrics, topology
    from repro_torch.sim.tick_profile import paper_case
    t0 = time.perf_counter()
    clos, topo, flows, cfg = paper_case(SEED)
    n_ticks = int(flows.horizon + PAPER_DRAIN)
    fops = engine.pack_flows(flows, cfg, "cuda")
    tops = topology.pack_topo(topo, device="cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    say(f"[paper] fabric P={topo.n_ports} servers={clos.n_servers} "
        f"switches={topo.n_switches}; flows={flows.n_flows} "
        f"horizon={flows.horizon} n_ticks={n_ticks} (drain {PAPER_DRAIN}, "
        f"not cut); setup {setup:.2f}s")

    ops.reset_launches()           # counts of the main path's run only
    t0 = time.perf_counter()
    st, emits, active = engine.simulate(
        topology.TopoDims.of(topo), cfg, fops, tops, n_ticks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)

    st = engine.to_numpy(st)
    emits = emits.cpu().numpy()
    m = metrics.summarize("bfc", st, emits, flows, n_links=topo.n_ports,
                          occ_bin_ref=clos.switch_buffer_pkts,
                          cap=cfg.proto.queue_cap)
    say(f"[paper] wall={wall:.2f}s active_ticks={active} "
        f"ticks_per_s={active / wall:.1f} completed={m.completed}/{m.total} "
        f"fct_slowdown_p99={m.fct_slowdown_p99:.4f} "
        f"fct_slowdown_avg={m.fct_slowdown_avg:.4f} drops={m.drops} "
        f"pauses={m.pauses} bfc_fused_launches={launches['bfc_fused']}")

    # the repo's own invariants on what came out
    if emits.shape != (n_ticks, 3) or int(st.t) != n_ticks:
        raise AssertionError(f"emits {emits.shape} / t {int(st.t)} for "
                             f"{n_ticks} ticks")
    if launches["bfc_fused"] != active:
        raise AssertionError(f"bfc_fused launched {launches['bfc_fused']} "
                             f"times for {active} simulated ticks")
    done = st.done >= 0
    if (st.delivered > flows.size_pkts).any() or \
            (st.delivered[done] != flows.size_pkts[done]).any() or \
            (st.done[done] < flows.arrival_tick[done]).any():
        raise AssertionError("delivery counters violate flow sizes")
    if not (m.completed > 0 and np.isfinite(m.fct_slowdown_p99)
            and np.isfinite(m.fct_slowdown_avg) and m.fct_slowdown_avg >= 1):
        raise AssertionError("FCT slowdowns are not finite and >= 1")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.bfc_step import bfc_step

    smi = smi_line()
    say(f"[setup] device={torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    say(f"[setup] nvidia-smi: {smi}")
    t0 = time.perf_counter()
    bfc_step.build()
    say(f"[setup] built {bfc_step.build_info['path']} in "
        f"{time.perf_counter() - t0:.2f}s")
    for line in bfc_step.build_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            say(f"[setup] ptxas: {line.strip()}")

    worst, timing = phase_kernels(torch)
    phase_golden(torch)
    launches = phase_paper(torch)

    src = "src/repro_torch/kernels/bfc_step/csrc/bfc_step.cu"
    replaces = {"bfc_fused": "src/repro/kernels/bfc_step/bfc_step.py:146",
                "bfc_decide": "src/repro/kernels/bfc_step/bfc_step.py:75"}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces[name], "launches": launches[name],
                "max_abs_err": worst[name], **timing[name],
                "library_ms": None}
               for name in ("bfc_fused", "bfc_decide")]
    say(f"[report] nvidia-smi: {smi}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
