"""Where the LM serving path's time goes on the card.

    PYTHONPATH=src python -m repro_torch.runtime.lm_profile

Builds full-width recurrentgemma-2b in bf16 (random weights from a
generator seeded with 0, as `chip_smoke.py` does), then for two windows --
one prefill at B=2, S=4096 (`make_prefill_step`) and TICKS decode ticks
on 8 slots (`make_decode_step`, per-slot lengths from 16 up) -- runs the
window once without and once under `torch.profiler`, and prints the wall
time of both runs and `tick_profile.print_breakdown` of the profiled one,
its idle share taken against the unprofiled wall time. Then it does the
same for one prefill of full-width rwkv6-3b at B=2, S=4096. Needs a CUDA
device; exits non-zero when the profiler records no device activity.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import configs, resolve_device
from ..models import model
from ..sim.tick_profile import kernel_events, print_breakdown
from . import steps

TICKS = 32     # decode ticks profiled


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _report(name: str, fn, n: int) -> bool:
    """Run `fn` (n steps of `name`) unprofiled, then profiled; print."""
    wall = _timed(fn)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_prof = _timed(fn)
    print(f"{name}: per step wall {wall_prof / n * 1e3:.3f} ms profiled")
    return print_breakdown(name, kernel_events(prof), n, wall)


def _prefill_window(name: str, dev, rng):
    """The model `name` in bf16 and its B=2, S=4096 prefill, warmed up."""
    cfg = configs.get(name)
    params = model.init_model(
        cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 4096))).to(dev)
    prefill = steps.make_prefill_step(cfg)
    prefill(params, tokens)                             # warm-up
    print(f"device={torch.cuda.get_device_name(0)} model={cfg.name} bf16")
    return cfg, params, lambda: prefill(params, tokens)


def main() -> int:
    dev = resolve_device("cuda")
    rng = np.random.default_rng(0)
    cfg, params, prefill = _prefill_window("recurrentgemma-2b", dev, rng)
    ok = _report("prefill B=2 S=4096", prefill, 1)

    decode = steps.make_decode_step(cfg)
    slots = 8
    cache = model.init_cache(cfg, slots, 128, device=dev)
    feed = torch.from_numpy(rng.integers(0, cfg.vocab, (slots, 1))).to(dev)
    kv = torch.arange(16, 16 + slots, device=dev)
    decode(params, cache, feed, kv)                     # warm-up

    def ticks():
        for i in range(TICKS):
            decode(params, cache, feed, kv + i)
    ok = _report(f"decode tick ({slots} slots)", ticks, TICKS) and ok

    del params, cache
    torch.cuda.empty_cache()
    _, _, prefill = _prefill_window("rwkv6-3b", dev, rng)
    ok = _report("rwkv6-3b prefill B=2 S=4096", prefill, 1) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
