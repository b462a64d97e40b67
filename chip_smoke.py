#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of the BFC simulator on one GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in order (any failure exits non-zero; no phase catches its own):

1. setup     -- device, torch version, `nvidia-smi` name and power limit;
                build the CUDA kernels from `src/repro_torch/.../csrc`,
                print ptxas's registers and spills for every kernel
                instance, and fail if one spills or has its wgmma
                serialised (C7520); count HGMMA, HMMA and local-memory
                instructions in the SASS (`cuobjdump`) of each bf16
                attention kernel and each `wkv_kernel`, and fail unless
                every attention kernel has HGMMA, every `wkv_kernel` HMMA,
                and none touches local memory.
2. kernels   -- `bfc_fused` as the main path runs it: the fused switch
                step (the kernel's derive mode: occupancy, head-of-queue
                Bloom lookup, PFC, arrivals at the sources and the pick, one
                launch per tick) against its plain torch version
                (`derive_ref`) on seeded states at FUSED_SHAPES (DRR and
                SRF; the flags of bfc, bfc_pfc and pfc; a tight and an
                infinite buffer) and on the paper case's state at tick 2048
                under bfc, bfc_srf and bfc_pfc; the standalone `bfc_fused`
                (DRR and SRF) and `bfc_decide` against theirs; exact
                equality of every output. CUDA-event timings of kernel,
                plain version and the memory/operation bound at the main
                path's shapes.
3. golden    -- all 16 PRESETS families on the pinned golden case through
                the graphed runner (a CUDA graph of `engine.GRAPH_TICKS`
                ticks, replayed), emits, trace channels and active ticks
                bit-for-bit against `tests/fixtures/traces/<family>.npz`.
4. lockstep  -- the paper case's first 1024 ticks through the graphed
                runner against `make_step`'s eager step, tick by tick:
                every `SimState` leaf and emit row equal.
5. paper     -- `bfc` on the paper's 128-server / 8 ToR / 8 spine Clos,
                fb_hadoop at load 0.6, seed 0, 4000 flows, horizon + 20000
                ticks, through the graphed runner: wall time, ticks/s, FCT
                slowdown, drops, pauses, and the `bfc_fused` launch count,
                which must equal the simulated ticks; the results must be
                the port's known ones (29184 active ticks, 4000/4000
                completed, p99 3.1873, avg 1.2394, 0 drops, 11064 pauses).
6. lm-kernels -- `flash_attention`, bf16 (the tensor-core kernel) at the
                prefill shape and at five small shapes (GQA causal;
                non-causal cross with ragged S and T; hd 256 with a
                sliding window over partial tiles; hd 96; hd 16 with S not
                a multiple of the 128-row q tile), and f32 (the CUDA-core
                kernel) at four small shapes (causal and not, hd 256 with
                a sliding window, hd 96); `rglru_scan` at the prefill
                shape and two small ones (S under one 128-token tile, W
                not a multiple of the 32-channel tile); each against its
                plain torch version within the stated tolerances, and
                `rglru_scan` called twice with equal results (its
                look-back scratch is reset every call); CUDA-event timings
                of kernel, plain version and SDPA, and the bounds.
7. lm-prefill -- full-width recurrentgemma-2b in bf16 (random weights from
                a seeded generator on the card): `make_prefill_step` at
                B=2, S=4096; wall time, tokens/s, finite logits, and exactly
                8 `flash_attention` and 18 `rglru_scan` launches.
8. lm-consistency -- the same model in f32 (TF32 off): the last-token
                logits and the caches of a 2560-token prefill (kernels)
                against the decode step fed the prompt token by token
                (plain torch), relative error <= 1e-3.
9. lm-serve  -- `BFCServer` on the bf16 model, 8 slots, 16 requests from 4
                clients, 16 new tokens each: all complete; tokens/s of
                this toy load (a smoke result, not a serving benchmark).
10. rwkv-kernels -- `wkv` against its plain version: bf16 r, k, v at the
                prefill shape (2, 4096, 40, 64) and f32 at six small
                shapes (D = 16, 32, 64; a ragged S = 37 against the
                token-by-token form, the others against the chunked form;
                log w = -5 throughout, the overflow edge of e^{-cs}), out
                and hT within 1e-5 of max|ref|, each called twice with
                equal results; CUDA-event timings of kernel and plain
                version, the bound (bytes against the chunked form's
                operations at the TF32 tensor rate).
11. rwkv-prefill -- full-width rwkv6-3b in bf16 (random weights from a
                seeded generator on the card), parameters within the JAX
                nameplate band: `make_prefill_step` at B=2, S=4096; wall
                time, tokens/s, finite logits, and exactly 32 `wkv` and no
                other LM kernel launches.
12. rwkv-consistency -- the same model in f32 (TF32 off): a 1024-token
                prefill (kernel) against the decode step fed the prompt
                token by token (plain torch), relative error <= 1e-3.
13. rwkv-serve -- `BFCServer` on the bf16 rwkv6-3b, the lm-serve load: all
                complete (a smoke result).
14. report   -- one `kernels` JSON line, then the device JSON line last.

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
# (2), running min (1), pause compare (1), occ_after update (2); the derive
# mode adds the occupancy (1) and the segmented reduction's 5 steps of 3
OPS_PER_ELEMENT = 14
OPS_PER_ELEMENT_DERIVE = 30
PAPER_DRAIN = 20_000
PAPER_STATE_TICK = 2048           # kernels phase: paper-case states here
PAPER_STATE_PRESETS = ("bfc", "bfc_srf", "bfc_pfc")
LOCKSTEP_TICKS = 1024
# what the paper run must give (the port's results since it was first run)
PAPER_EXPECT = {"active_ticks": 29184, "completed": 4000, "total": 4000,
                "p99": "3.1873", "avg": "1.2394", "drops": 0,
                "pauses": 11064}
GOLDEN_WORKERS = 4

# LM slice: recurrentgemma-2b prefill + BFCServer decode
LM_ARCH = "recurrentgemma-2b"
PREFILL_B, PREFILL_S = 2, 4096
CONSISTENCY_S = 2560              # longer than the 2048-token window
SERVE = dict(n_slots=8, max_len=128, requests=16, max_new=16)
# (B, H, K, S, T, hd, causal, window): the prefill's local attention; small
# bf16 cases: causal with GQA; non-causal cross with S and T not multiples
# of the q and kv tiles; the path's hd = 256 with a sliding window over
# partial tiles; phi3-mini's hd = 96; hd = 16 with S not a multiple of 128
FLASH_PATH = (2, 10, 1, 4096, 4096, 256, True, 2048)
FLASH_SMALL_BF16 = [(2, 4, 2, 128, 128, 64, True, 0),
                    (1, 8, 4, 130, 200, 64, False, 0),
                    (1, 2, 1, 320, 320, 256, True, 100),
                    (1, 4, 4, 160, 160, 96, True, 0),
                    (2, 4, 4, 200, 200, 16, True, 0)]
# small float32 cases: causal with GQA; non-causal cross, T != S; the
# path's hd = 256 and sliding window over 5 q tiles and 10 kv tiles, some
# of them skipped; phi3-mini's hd = 96
FLASH_SMALL = [(2, 4, 2, 128, 128, 64, True, 0),
               (1, 8, 4, 128, 256, 64, False, 0),
               (1, 2, 1, 320, 320, 256, True, 100),
               (1, 4, 4, 160, 160, 96, True, 0)]
SCAN_PATH = (2, 4096, 2560)       # the prefill's RG-LRU scan (B, S, W)
# small scans: S under one 128-token tile, and with W not a multiple of
# the 32-channel tile
SCAN_SMALL = [(3, 72, 96), (2, 100, 40)]
# Tolerances (atol, rtol), |got - want| <= atol + rtol * |want|: attention
# in float32 2e-5 as the JAX package's kernel test (tests/test_kernels.py:51);
# in bf16 the kernel rounds P to bf16 before the P V product on the tensor
# cores (2^-9 relative per term, mostly averaging out over a row's keys),
# while the plain version keeps P in float32; both accumulate in float32
# and round the output once, so they differ by about one bf16 ulp (2^-7 of
# |want| at most) plus P's rounding: 1e-2 relative, 4e-3 absolute for
# outputs near 0. The scan 1e-4 (the kernel sums sequentially, the plain
# version in the chunked cumsum form; the kernel composes sub-chunk and
# tile pairs, then steps sequentially from each carry)
FLASH_TOL = {"bfloat16": (4e-3, 1e-2), "float32": (2e-5, 2e-5)}
SCAN_TOL = (1e-4, 1e-4)
LM_REL_TOL = 1e-3                 # lm-consistency: max|d| / max|ref|

# RWKV slice: rwkv6-3b prefill + BFCServer decode
RWKV_ARCH = "rwkv6-3b"
RWKV_CONSISTENCY_S = 1024         # 64 chunks of the plain version's 16
RWKV_PARAMS = (2.5e9, 3.1e9)      # tests/test_models_smoke.py:122
WKV_PATH = (2, 4096, 40, 64)      # the prefill's WKV (B, S, H, D), bf16
# small f32 cases (B, S, H, D, log w = -5 throughout): the JAX package's
# kernel test shapes; a ragged S (37, against the token-by-token form);
# the reduced config's D = 16; the overflow edge of e^{-cs} (e^80)
WKV_SMALL = [((1, 128, 4, 32), False), ((2, 32, 1, 64), False),
             ((2, 64, 2, 64), False), ((1, 37, 2, 64), False),
             ((2, 64, 2, 16), False), ((1, 64, 2, 64), True)]
# max|d| / max|ref| on out and hT: the kernel and the plain version both
# take 16-token chunks, the kernel with 3xTF32 tensor-core products (each
# ~2^-21 relative; single-pass TF32 misses by ~50x); the JAX package's
# chunked and token-by-token forms are 3.9e-7 apart in float32 at
# (1, 2048, 2, 64)
WKV_REL_TOL = 1e-5
# H100 SXM dense peaks (NVIDIA data sheet): bf16 and TF32 tensor cores,
# and float32 outside the tensor cores (the scan's exp and multiply-add)
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12


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


def derive_bound(args, kw, want):
    """(bound_ms, bound_by) of one fused switch step (derive mode) on these
    operands: each input the kernel needs read once, each output written
    once, over HBM bandwidth; integer operations over the INT32 peak. The
    head-of-queue lookup (one qbuf entry, S fpos entries and S Bloom bytes)
    is counted for the non-empty queues only, the SRF key for the active
    ones only: what this state's data needs (csrc/bfc_step.cu)."""
    qhead, fpos = args[0], args[9]
    p, q = qhead.shape
    f, s = fpos.shape
    n = p * q
    nonempty = int((want.occ > 0).sum())
    active = int(((want.occ > 0) & ~want.qpaused).sum())
    n_in = (8 * n + 12 * f + 8 + 5 * p
            + (4 * active if kw["scheduler"] == "srf" else 4 * p)
            + (nonempty * (4 + 5 * s) if kw["backpressure"] else 0)
            + (9 * p if kw["pfc"] else 0))
    n_out = 9 * n + 14 * p + 4 * kw["n_switches"] + 4 * f
    t_bytes = (n_in + n_out) / HBM_BYTES_PER_S * 1e3
    t_ops = n * OPS_PER_ELEMENT_DERIVE / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paper_state(torch, name, n_ticks):
    """(args, kwargs) of the fused switch step on the paper case's state
    under preset `name` after `n_ticks` ticks on the card."""
    from dataclasses import replace
    from repro_torch.sim import engine, phases, topology
    from repro_torch.sim.config import PRESETS
    from repro_torch.sim.tick_profile import paper_case
    _, topo, flows, cfg = paper_case(SEED)
    cfg = replace(cfg, proto=PRESETS[name])
    dims = topology.TopoDims.of(topo)
    fops = engine.pack_flows(flows, cfg, "cuda")
    tops = topology.pack_topo(topo, device="cuda")
    st, _, _ = engine.simulate(dims, cfg, fops, tops, n_ticks,
                               early_exit=False)
    env = phases.make_env(dims, cfg, flows.n_flows, "cuda")
    return phases.derive_operands(env, st, fops, tops)


def check_derive(torch, what, args, kw) -> int:
    from repro_torch.kernels.bfc_step import bfc_step, ref
    got = bfc_step.derive(*args, **kw)
    want = ref.derive_ref(*args, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    if err:
        raise AssertionError(f"the fused switch step {what} differs from its "
                             "plain version: " + ", ".join(
                                 name for name, g, w in zip(
                                     ref.DeriveOut._fields, got, want)
                                 if not torch.equal(g, w)))
    return want


def phase_derive(torch):
    """The main path's kernel (the fused switch step) against its plain
    version, exact, on seeded and paper-case states; its timings at the
    paper case's state at tick PAPER_STATE_TICK under `bfc`."""
    from repro_torch import testing
    from repro_torch.kernels.bfc_step import bfc_step, ref
    flags = {"bfc": (True, False), "bfc_pfc": (True, True),
             "pfc": (False, True)}        # backpressure, pfc
    n = 0
    for p, q in FUSED_SHAPES:
        for sched in ("drr", "srf"):
            for fam, (bp, pfc) in flags.items():
                for limit in (None, 1 << 29):
                    args = testing.random_derive_inputs(
                        SEED + n, p, q, "cuda", buffer_limit=limit)
                    kw = dict(n_switches=16, backpressure=bp, pfc=pfc,
                              scheduler=sched, pfc_frac=0.11,
                              pause_window=PAUSE_WINDOW)
                    check_derive(torch, f"{fam} {sched} ({p},{q})", args, kw)
                    n += 1
    say(f"[kernels] bfc_fused (fused switch step) {n} seeded states at "
        f"{FUSED_SHAPES}: max_abs_err=0")
    states = {}
    for name in PAPER_STATE_PRESETS:
        t0 = time.perf_counter()
        args, kw = paper_state(torch, name, PAPER_STATE_TICK)
        want = check_derive(torch, f"paper {name}", args, kw)
        states[name] = (args, kw, want)
        say(f"[kernels] bfc_fused (fused switch step) paper case {name} "
            f"tick {PAPER_STATE_TICK}: max_abs_err=0; "
            f"{int((want.occ > 0).sum())} non-empty queues, "
            f"{int(want.kcan_tx.sum())} ports transmit, "
            f"{int(want.qpaused.sum())} head-paused, "
            f"{int(want.pfc_paused.sum())} PFC-paused "
            f"({time.perf_counter() - t0:.2f}s)")

    args, kw, want = states["bfc"]
    kern = lambda: bfc_step.derive(*args, **kw)          # noqa: E731
    plain = lambda: ref.derive_ref(*args, **kw)          # noqa: E731
    host = {"plain": time_ms(torch, plain), "kernel": time_ms(torch, kern)}
    dev = {"plain": [device_ms(torch, plain)]}           # in turns
    dev["kernel"] = [device_ms(torch, kern), device_ms(torch, kern)]
    dev["plain"].append(device_ms(torch, plain))
    b_ms, b_by = derive_bound(args, kw, want)
    say(f"[kernels] time bfc_fused (fused switch step) paper bfc state, "
        f"P={args[0].shape[0]} Q={args[0].shape[1]} per call: device (CUDA "
        f"graph of {GRAPH_CALLS} calls, CUDA events) kernel "
        + "/".join(f"{v * 1e3:.3f}" for v in dev["kernel"])
        + " us, plain " + "/".join(f"{v * 1e3:.3f}" for v in dev["plain"])
        + f" us; issued eagerly from Python ({TIMED_LAUNCHES} calls) kernel "
        f"{host['kernel'] * 1e3:.3f} us, plain {host['plain'] * 1e3:.3f} us;"
        f" bound {b_ms * 1e3:.4f} us ({b_by})")
    return {"ms": min(dev["kernel"]), "plain_ms": min(dev["plain"]),
            "bound_ms": b_ms, "bound_by": b_by}


def phase_kernels(torch):
    from repro_torch.kernels.bfc_step import bfc_step, ref
    rng = np.random.default_rng(SEED)
    worst = {"bfc_fused": 0, "bfc_decide": 0}
    main_timing = phase_derive(torch)
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
        say(f"[kernels] time {name} (standalone) P={p} Q={q} per call: device "
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
    say(f"[kernels] time bfc_fused (standalone) srf P={p} Q={q} per call: "
        f"device {srf * 1e3:.3f} us, bound "
        f"{bound(p, q, fused=True, srf=True)[0] * 1e3:.4f} us")
    # the kernels line's bfc_fused row is the main path's kernel
    timing["bfc_fused"] = main_timing
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


def paper_operands(torch):
    from repro_torch.sim import engine, topology
    from repro_torch.sim.tick_profile import paper_case
    clos, topo, flows, cfg = paper_case(SEED)
    return (clos, topo, flows, cfg, topology.TopoDims.of(topo),
            engine.pack_flows(flows, cfg, "cuda"),
            topology.pack_topo(topo, device="cuda"))


def phase_lockstep(torch):
    """The graphed runner against `make_step`'s eager step on the paper
    case's first LOCKSTEP_TICKS ticks: every leaf and emit row equal."""
    from repro_torch import testing
    from repro_torch.sim import engine
    _, _, _, cfg, dims, fops, tops = paper_operands(torch)
    t0 = time.perf_counter()
    st, emits, _ = engine.simulate(dims, cfg, fops, tops, LOCKSTEP_TICKS,
                                   early_exit=False)
    torch.cuda.synchronize()
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.inference_mode():
        _, init_state, step = engine.make_step(dims, cfg,
                                               fops.arrival.shape[0], "cuda")
        eager, rows = init_state(), []
        for _ in range(LOCKSTEP_TICKS):
            eager, row = step(eager, fops, tops)
            rows.append(row)
        rows = torch.stack(rows)
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    testing.assert_state_equal(st, eager, "paper case, graphed vs eager")
    if not torch.equal(emits, rows):
        raise AssertionError("paper case: graphed and eager emit rows differ")
    say(f"[lockstep] paper case, {LOCKSTEP_TICKS} ticks: graphed runner "
        f"{t_graph:.2f}s (capture included), eager steps {t_eager:.2f}s; "
        f"every SimState leaf and emit row equal")


def phase_paper(torch):
    from repro_torch.kernels.bfc_step import ops
    from repro_torch.sim import engine, metrics
    t0 = time.perf_counter()
    clos, topo, flows, cfg, dims, fops, tops = paper_operands(torch)
    n_ticks = int(flows.horizon + PAPER_DRAIN)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    say(f"[paper] fabric P={topo.n_ports} servers={clos.n_servers} "
        f"switches={topo.n_switches}; flows={flows.n_flows} "
        f"horizon={flows.horizon} n_ticks={n_ticks} (drain {PAPER_DRAIN}, "
        f"not cut); setup {setup:.2f}s")

    ops.reset_launches()           # counts of the main path's run only
    t0 = time.perf_counter()
    st, emits, active = engine.simulate(dims, cfg, fops, tops, n_ticks)
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
    got = {"active_ticks": active, "completed": m.completed,
           "total": m.total, "p99": f"{m.fct_slowdown_p99:.4f}",
           "avg": f"{m.fct_slowdown_avg:.4f}", "drops": m.drops,
           "pauses": m.pauses}
    if got != PAPER_EXPECT:
        raise AssertionError(f"paper results {got} != {PAPER_EXPECT}")
    done = st.done >= 0
    if (st.delivered > flows.size_pkts).any() or \
            (st.delivered[done] != flows.size_pkts[done]).any() or \
            (st.done[done] < flows.arrival_tick[done]).any():
        raise AssertionError("delivery counters violate flow sizes")
    if not (m.completed > 0 and np.isfinite(m.fct_slowdown_p99)
            and np.isfinite(m.fct_slowdown_avg) and m.fct_slowdown_avg >= 1):
        raise AssertionError("FCT slowdowns are not finite and >= 1")
    return launches


def build_kernels():
    """One nvcc per kernel source, all started together. Fails if ptxas
    reports a spill or serialised wgmma (C7520) in any kernel, if a bf16
    attention kernel's SASS has no HGMMA or a `wkv_kernel`'s no HMMA, or
    if either touches local memory."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.bfc_step import bfc_step
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru import rglru
    from repro_torch.kernels.rwkv6 import wkv
    t0 = time.perf_counter()
    mods = (bfc_step, flash_attention, rglru, wkv)
    with ThreadPoolExecutor(len(mods)) as ex:
        paths = list(ex.map(lambda m: m.build(), mods))
    say(f"[setup] built {', '.join(p.name for p in paths)} in "
        f"{time.perf_counter() - t0:.2f}s")
    for m in mods:
        lines, spilled, serialized = nvcc.ptxas_report(
            nvcc.build_info[str(m.SOURCE)]["log"])
        for line in lines:
            say(f"[setup] ptxas {m.SOURCE.name} {line}")
        if spilled or serialized:
            raise AssertionError(
                f"a kernel of {m.SOURCE.name} "
                + ("spills registers to local memory" if spilled else
                   "has its wgmma serialised by ptxas (C7520)"))
    for path, prefix, op, n in (
            (paths[1], "flash_fwd_bf16_kernel", "hgmma",
             len(flash_attention.HEAD_DIMS)),
            (paths[3], "wkv_kernel", "hmma", 2 * len(wkv.HEAD_DIMS))):
        sass = {fn: c for fn, c in nvcc.sass_counts(path).items()
                if fn.startswith(prefix)}
        for fn, c in sass.items():
            say(f"[setup] sass {fn}: {c.hgmma} HGMMA, {c.hmma} HMMA, "
                f"{c.local} LDL/STL")
        if len(sass) != n or any(getattr(c, op) == 0 or c.local
                                 for c in sass.values()):
            raise AssertionError(f"every {prefix} instance must use "
                                 f"{op.upper()} and no local memory")


def repeat(torch, name, shape, got, again) -> None:
    """Two calls on the same inputs give identical outputs."""
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError(f"{name} {shape}: a second call on the same "
                             "inputs gives other results")


def within(torch, got, want, tol) -> float:
    """max |got - want|; raises unless |got - want| <= atol + rtol*|want|
    everywhere, (atol, rtol) = tol, and every value is finite."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)}/{got.dtype} != "
                             f"{tuple(want.shape)}/{want.dtype}")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("kernel output is not finite")
    diff = (g - w).abs()
    atol, rtol = tol
    if bool((diff > atol + rtol * w.abs()).any()):
        raise AssertionError(f"max_abs_err {float(diff.max())} beyond tol "
                             f"{tol}")
    return float(diff.max())


def event_ms(torch, fn, n) -> float:
    """ms per call: CUDA events around `n` back-to-back calls, after two
    warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(n):
            fn()
    return _events(torch, run, n)


def attention_pairs(s, t, causal, window) -> int:
    """Unmasked (q, k) pairs of one (batch, head)."""
    q = np.arange(s)
    hi = np.minimum(q + 1, t) if causal else np.full(s, t)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(s, int)
    return int(np.maximum(hi - lo, 0).sum())


def flash_bound(b, h, kh, s, t, hd, causal, window, itemsize):
    flops = 4 * hd * attention_pairs(s, t, causal, window) * b * h
    peak = BF16_FLOPS if itemsize == 2 else F32_FLOPS
    nbytes = itemsize * hd * (2 * b * h * s + 2 * b * kh * t)
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def scan_bound(b, s, w):
    t_bytes = (12 * b * s * w + 8 * b * w) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * b * s * w / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_inputs(torch, gen, b, h, kh, s, t, hd, dtype):
    """q as the model hands it over: a (B,H,S,hd) view of (B,S,H,hd)."""
    q = torch.randn((b, s, h, hd), generator=gen, device="cuda",
                    dtype=torch.float32).to(dtype).transpose(1, 2)
    k, v = (torch.randn((b, kh, t, hd), generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype) for _ in range(2))
    return q, k, v


def scan_inputs(torch, gen, b, s, w):
    log_a = -torch.rand((b, s, w), generator=gen, device="cuda") * 0.1
    bb = torch.randn((b, s, w), generator=gen, device="cuda")
    h0 = torch.randn((b, w), generator=gen, device="cuda")
    return log_a, bb, h0


def phase_lm_kernels(torch):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rglru import rglru
    from repro_torch.kernels.rglru.ref import rglru_scan_ref
    gen = torch.Generator("cuda").manual_seed(SEED)
    worst = {"flash_attention": 0.0, "rglru_scan": 0.0}
    for shape, dtype in ([(FLASH_PATH, torch.bfloat16)]
                         + [(c, torch.bfloat16) for c in FLASH_SMALL_BF16]
                         + [(c, torch.float32) for c in FLASH_SMALL]):
        b, h, kh, s, t, hd, causal, window = shape
        q, k, v = flash_inputs(torch, gen, b, h, kh, s, t, hd, dtype)
        args = dict(causal=causal, window=window)
        got = fa.flash_attention(q, k, v, **args)
        want = attention_ref(q, k, v, **args)
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        err = within(torch, got, want, FLASH_TOL[name])
        say(f"[lm-kernels] flash_attention {name} {shape} max_abs_err="
            f"{err:.3e} (atol, rtol {FLASH_TOL[name]})")
        worst["flash_attention"] = max(worst["flash_attention"], err)
    for b, s, w in [SCAN_PATH] + SCAN_SMALL:
        la, bb, h0 = scan_inputs(torch, gen, b, s, w)
        got = rglru.rglru_scan(la, bb, h0)
        again = rglru.rglru_scan(la, bb, h0)
        want = rglru_scan_ref(la, bb, h0)
        torch.cuda.synchronize()
        err = max(within(torch, g, w_, SCAN_TOL) for g, w_ in zip(got, want))
        repeat(torch, "rglru_scan", (b, s, w), got, again)
        say(f"[lm-kernels] rglru_scan {(b, s, w)} max_abs_err={err:.3e} "
            f"(atol, rtol {SCAN_TOL}); a second call equal")
        worst["rglru_scan"] = max(worst["rglru_scan"], err)

    # timings at the prefill's shapes
    b, h, kh, s, t, hd, causal, window = FLASH_PATH
    q, k, v = flash_inputs(torch, gen, b, h, kh, s, t, hd, torch.bfloat16)
    args = dict(causal=causal, window=window)
    qpos = torch.arange(s, device="cuda")[:, None]
    kpos = torch.arange(t, device="cuda")[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window)
    k_rep, v_rep = (x.repeat_interleave(h // kh, dim=1) for x in (k, v))
    qc = q.contiguous()
    plain = [event_ms(torch, lambda: attention_ref(q, k, v, **args), 3)]
    kern = [event_ms(torch, lambda: fa.flash_attention(q, k, v, **args), 10)
            for _ in range(2)]
    plain.append(event_ms(torch, lambda: attention_ref(q, k, v, **args), 3))
    lib = event_ms(torch, lambda: F.scaled_dot_product_attention(
        qc, k_rep, v_rep, attn_mask=mask), 10)
    b_ms, b_by = flash_bound(*FLASH_PATH, itemsize=2)
    timing = {"flash_attention": {
        "ms": min(kern), "plain_ms": min(plain), "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib}}
    say(f"[lm-kernels] time flash_attention bf16 {FLASH_PATH}: kernel "
        + "/".join(f"{x:.4f}" for x in kern) + " ms, plain "
        + "/".join(f"{x:.4f}" for x in plain) + f" ms, SDPA (bool mask) "
        f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"{attention_pairs(s, t, causal, window)} unmasked pairs per (b,h)")
    la, bb, h0 = scan_inputs(torch, gen, *SCAN_PATH)
    plain = [event_ms(torch, lambda: rglru_scan_ref(la, bb, h0), 5)]
    kern = [event_ms(torch, lambda: rglru.rglru_scan(la, bb, h0), 20)
            for _ in range(2)]
    plain.append(event_ms(torch, lambda: rglru_scan_ref(la, bb, h0), 5))
    b_ms, b_by = scan_bound(*SCAN_PATH)
    timing["rglru_scan"] = {"ms": min(kern), "plain_ms": min(plain),
                            "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": None}
    say(f"[lm-kernels] time rglru_scan {SCAN_PATH}: kernel "
        + "/".join(f"{x:.4f}" for x in kern) + " ms, plain "
        + "/".join(f"{x:.4f}" for x in plain)
        + f" ms, bound {b_ms:.4f} ms ({b_by})")
    return worst, timing


def wkv_inputs(torch, gen, b, s, h, d, dtype, clip=False):
    """r, k, v in `dtype`; log w in the model's clipped range, or -5
    throughout (`clip`); a non-zero h0."""
    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    r, k, v = (normal(b, s, h, d).mul(0.5).to(dtype) for _ in range(3))
    logw = -normal(b, s, h, d).clamp(-10.0, 1.6).exp().clamp(1e-6, 5.0)
    if clip:
        logw = torch.full_like(logw, -5.0)
    return r, k, v, logw, normal(h, d) * 0.3, normal(b, h, d, d) * 0.2


def wkv_bound(b, s, h, d, itemsize):
    """(bound_ms, bound_by, bytes, operations). Bytes: r, k, v in the
    input type, logw, u, h0 read and out, hT written once, float32
    otherwise. Operations: the chunked form's products per chunk and head
    -- att = r_dec k_sc^T and att v (2 C^2 D each), r_dec S and k_dec^T v
    (2 C D^2 each) -- at the dense TF32 tensor rate."""
    from repro_torch.kernels.rwkv6.ref import CHUNK as C
    n = b * s * h * d
    nbytes = 3 * itemsize * n + 4 * (2 * n + h * d + 2 * b * h * d * d)
    flops = b * h * -(-s // C) * (4 * C * C * d + 4 * C * d * d)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / TF32_FLOPS * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, nbytes, flops


def phase_rwkv_kernels(torch):
    from repro_torch.kernels.rwkv6 import wkv
    from repro_torch.kernels.rwkv6.ref import wkv_chunked_ref, wkv_seq_ref
    gen = torch.Generator("cuda").manual_seed(SEED)
    worst = 0.0
    for shape, dtype, clip in ([(WKV_PATH, torch.bfloat16, False)]
                               + [(c, torch.float32, clip)
                                  for c, clip in WKV_SMALL]):
        x = wkv_inputs(torch, gen, *shape, dtype, clip)
        got = wkv.wkv(*x)
        again = wkv.wkv(*x)
        # the chunked form takes whole chunks; a ragged S the
        # token-by-token form
        plain = wkv_chunked_ref if shape[1] % 16 == 0 else wkv_seq_ref
        want = plain(*x)
        torch.cuda.synchronize()
        repeat(torch, "wkv", shape, got, again)
        rel, err = 0.0, 0.0
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype or \
                    not bool(torch.isfinite(g).all()):
                raise AssertionError(f"wkv {shape}: {tuple(g.shape)}/"
                                     f"{g.dtype} != {tuple(w.shape)}/"
                                     f"{w.dtype} or not finite")
            rel = max(rel, rel_err(torch, g, w))
            err = max(err, float((g - w).abs().max()))
        name = str(dtype).split(".")[-1]
        say(f"[rwkv-kernels] wkv {name} {shape}{' logw=-5' if clip else ''}"
            f" max_abs_err={err:.3e} max|d|/max|ref|={rel:.3e} (tol "
            f"{WKV_REL_TOL}, against {plain.__name__}); a second call "
            f"equal")
        if not rel <= WKV_REL_TOL:
            raise AssertionError(f"wkv {shape} differs from its plain "
                                 f"version: {rel:.3e}")
        worst = max(worst, err)

    x = wkv_inputs(torch, gen, *WKV_PATH, torch.bfloat16)
    plain = [event_ms(torch, lambda: wkv_chunked_ref(*x), 3)]
    kern = [event_ms(torch, lambda: wkv.wkv(*x), 20) for _ in range(2)]
    plain.append(event_ms(torch, lambda: wkv_chunked_ref(*x), 3))
    b_ms, b_by, nbytes, flops = wkv_bound(*WKV_PATH, itemsize=2)
    timing = {"ms": min(kern), "plain_ms": min(plain), "bound_ms": b_ms,
              "bound_by": b_by, "library_ms": None}
    say(f"[rwkv-kernels] time wkv bf16 {WKV_PATH}: kernel "
        + "/".join(f"{t:.4f}" for t in kern) + " ms, plain "
        + "/".join(f"{t:.4f}" for t in plain)
        + f" ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} bytes at "
        f"{HBM_BYTES_PER_S / 1e12} TB/s = "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; {flops} chunked-form "
        f"operations at {TF32_FLOPS / 1e12:.0f} TFLOP/s TF32 = "
        f"{flops / TF32_FLOPS * 1e3:.4f} ms); no single PyTorch call")
    return worst, timing


def lm_reset():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru import ops as lru_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    fa_ops.reset_launches()
    lru_ops.reset_launches()
    wkv_ops.reset_launches()


def lm_launches():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru import ops as lru_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    return {**fa_ops.launches, **lru_ops.launches, **wkv_ops.launches}


def run_prefill(torch, tag, arch):
    """Full-width `arch` in bf16 from a seeded generator on the card: one
    warm-up prefill at (PREFILL_B, PREFILL_S), then one timed with the LM
    kernels' counts set to 0 just before and read just after. Returns
    (cfg, params, launches, logits, cache)."""
    from repro_torch import configs
    from repro_torch.models import model, nn
    from repro_torch.runtime import steps
    cfg = configs.get(arch)
    t0 = time.perf_counter()
    params = model.init_model(
        cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    n_full, rem = cfg.layer_plan
    say(f"[{tag}] {cfg.name} {str(cfg.param_dtype).split('.')[-1]}: "
        f"{nn.count_params(params)} parameters, {n_full} units of "
        f"{cfg.pattern} + {rem}; init {time.perf_counter() - t0:.2f}s")
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (PREFILL_B, PREFILL_S))).cuda()
    prefill = steps.make_prefill_step(cfg)
    prefill(params, tokens)                       # warm-up (cuBLAS, build)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lm_reset()                     # counts of the main path's run only
    t0 = time.perf_counter()
    logits, cache = prefill(params, tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lm_launches()
    n_tok = PREFILL_B * PREFILL_S
    say(f"[{tag}] B={PREFILL_B} S={PREFILL_S}: wall={wall:.4f}s "
        f"prefill_tokens_per_s={n_tok / wall:.1f} launches={launches} "
        f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    if tuple(logits.shape) != (PREFILL_B, 1, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             "finite or of the wrong shape")
    return cfg, params, launches, logits, cache


def phase_lm_prefill(torch):
    cfg, params, launches, _, cache = run_prefill(torch, "lm-prefill",
                                                  LM_ARCH)
    n_local = sum(cfg.block_kind(i) == "local" for i in range(cfg.n_layers))
    n_rec = sum(cfg.block_kind(i) == "rec" for i in range(cfg.n_layers))
    if launches != {"flash_attention": n_local, "rglru_scan": n_rec,
                    "wkv": 0} or (n_local, n_rec) != (8, 18):
        raise AssertionError(f"prefill launched {launches}, expected "
                             f"flash_attention 8 and rglru_scan 18")
    if cache["rem_1"]["h"].shape != (PREFILL_B, cfg.rnn_w):
        raise AssertionError("prefill cache has the wrong layout")
    return cfg, params, launches


def phase_rwkv_prefill(torch):
    from repro_torch.models import nn
    cfg, params, launches, _, cache = run_prefill(torch, "rwkv-prefill",
                                                  RWKV_ARCH)
    n = nn.count_params(params)
    if not RWKV_PARAMS[0] <= n <= RWKV_PARAMS[1]:
        raise AssertionError(f"{n} parameters outside the nameplate band "
                             f"{RWKV_PARAMS}")
    if launches != {"flash_attention": 0, "rglru_scan": 0, "wkv": 32} or \
            cfg.n_layers != 32:
        raise AssertionError(f"prefill launched {launches}, expected wkv "
                             f"32 and no other LM kernel")
    hd = cfg.rwkv_head_dim
    if cache["units"][31]["b0"]["S"].shape != (
            PREFILL_B, cfg.d_model // hd, hd, hd):
        raise AssertionError("prefill cache has the wrong layout")
    return cfg, params, launches


def rel_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def phase_consistency(torch, tag, arch, s):
    """Prefill (kernels) against the decode step fed the prompt token by
    token (plain torch): an independent path through the same weights."""
    from repro_torch import configs
    from repro_torch.models import model
    from repro_torch.runtime import steps
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get(arch).with_(param_dtype=torch.float32,
                                  compute_dtype=torch.float32)
    params = model.init_model(
        cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(SEED))
    rng = np.random.default_rng(SEED + 1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, s))).cuda()
    t0 = time.perf_counter()
    lp, cp = steps.make_prefill_step(cfg)(params, tokens)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    decode = steps.make_decode_step(cfg)
    cd = model.init_cache(cfg, 1, s, device="cuda")
    t0 = time.perf_counter()
    for i in range(s):
        ld, cd = decode(params, cd, tokens[:, i:i + 1],
                        torch.full((1,), i, device="cuda"))
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    errs = {"logits": rel_err(torch, lp, ld)}
    blocks = [(f"units.{u}.{b}", cp["units"][u][b], cd["units"][u][b])
              for u in range(len(cp["units"])) for b in cp["units"][u]]
    blocks += [(k, cp[k], cd[k]) for k in cp if k != "units"]
    for name, a, d in blocks:
        for leaf in a:
            errs[f"{name}.{leaf}"] = rel_err(torch, d[leaf], a[leaf])
    worst = max(errs, key=errs.get)
    first = max(v for k, v in errs.items() if k.startswith("units.0."))
    top1 = (int(lp[0, -1].argmax()), int(ld[0, -1].argmax()))
    say(f"[{tag}] {cfg.name} f32 S={s}: prefill {t_prefill:.2f}s, "
        f"{s} decode steps {t_decode:.2f}s; max|dlogit|/max|logit|"
        f"={errs['logits']:.3e}; worst cache leaf {worst} {errs[worst]:.3e} "
        f"over {len(errs) - 1} leaves, worst of the first unit {first:.3e} "
        f"(tol {LM_REL_TOL}); top-1 prefill/decode {top1[0]}/{top1[1]} "
        f"(information only)")
    bad = {k: v for k, v in errs.items() if not v <= LM_REL_TOL}
    if bad:
        raise AssertionError(f"prefill and decode disagree: {bad}")
    return errs


def phase_serve(torch, tag, cfg, params):
    from repro_torch.launch import serve
    from repro_torch.runtime import serving
    srv = serving.BFCServer(cfg, params, n_slots=SERVE["n_slots"],
                            max_len=SERVE["max_len"])
    reqs = serve.make_requests(cfg.vocab, SERVE["requests"],
                               SERVE["max_new"])
    lm_reset()
    done, wall = serve.serve(srv, reqs)
    toks = sum(len(r.out) for r in done)
    st = srv.stats
    say(f"[{tag}] {cfg.name} bf16, {SERVE['n_slots']} slots: "
        f"{st.completed}/{len(reqs)} requests, {toks} tokens in {wall:.2f}s "
        f"= {toks / wall:.1f} tokens/s over {st.ticks} ticks "
        f"({wall / st.ticks * 1e3:.2f} ms/tick); pauses={st.pauses_sent} "
        f"resumes={st.resumes_sent} peak_pending={st.peak_pending}; "
        f"LM kernel launches {lm_launches()} (decode is plain torch)")
    if st.completed != len(reqs) or sorted(r.rid for r in done) != \
            list(range(len(reqs))) or \
            any(len(r.out) != SERVE["max_new"] for r in done):
        raise AssertionError("not every request completed with max_new "
                             "tokens")
    if any(not 0 <= t < cfg.vocab for r in done for t in r.out):
        raise AssertionError("served token out of the vocabulary")


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    smi = smi_line()
    say(f"[setup] device={torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    say(f"[setup] nvidia-smi: {smi}")
    build_kernels()

    worst, timing = phase_kernels(torch)
    phase_golden(torch)
    phase_lockstep(torch)
    launches = phase_paper(torch)
    lm_worst, lm_timing = phase_lm_kernels(torch)
    cfg, params, lm_counts = phase_lm_prefill(torch)
    phase_consistency(torch, "lm-consistency", LM_ARCH, CONSISTENCY_S)
    phase_serve(torch, "lm-serve", cfg, params)
    del cfg, params
    torch.cuda.empty_cache()
    lm_worst["wkv"], lm_timing["wkv"] = phase_rwkv_kernels(torch)
    cfg, params, rwkv_counts = phase_rwkv_prefill(torch)
    phase_consistency(torch, "rwkv-consistency", RWKV_ARCH,
                      RWKV_CONSISTENCY_S)
    phase_serve(torch, "rwkv-serve", cfg, params)

    kdir = "src/repro_torch/kernels"
    rows = [("bfc_fused", f"{kdir}/bfc_step/csrc/bfc_step.cu",
             "src/repro/kernels/bfc_step/bfc_step.py:146", launches),
            ("bfc_decide", f"{kdir}/bfc_step/csrc/bfc_step.cu",
             "src/repro/kernels/bfc_step/bfc_step.py:75", launches),
            ("flash_attention",
             f"{kdir}/flash_attention/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:86",
             lm_counts),
            ("rglru_scan", f"{kdir}/rglru/csrc/rglru.cu",
             "src/repro/kernels/rglru/rglru.py:55", lm_counts),
            ("wkv", f"{kdir}/rwkv6/csrc/wkv.cu",
             "src/repro/kernels/rwkv6/rwkv6.py:68", rwkv_counts)]
    worst.update(lm_worst)
    timing = {**{k: {**v, "library_ms": None} for k, v in timing.items()},
              **lm_timing}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": counts[name],
                "max_abs_err": worst[name], **timing[name]}
               for name, src, replaces, counts in rows]
    say(f"[report] nvidia-smi: {smi}")
    say(f"[report] chip_smoke.py took {time.perf_counter() - t_start:.1f}s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
