"""Serving launcher: continuous batching with BFC admission control, on
the card unless `--device cpu` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --no-reduced --requests 16 --slots 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --no-reduced

`--reduced` (the default) serves the small same-family config;
`--no-reduced` serves the full published one. Weights are random, drawn
from a `torch.Generator` seeded with 0.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs, resolve_device
from ..models import model
from ..runtime import serving


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="phi3-mini-3.8b",
                    choices=list(configs.ARCHS))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    return ap


def make_requests(vocab: int, n: int, max_new: int):
    """`n` requests from 4 clients with prompts of 2-7 tokens, drawn as the
    JAX launcher draws them."""
    rng = np.random.default_rng(0)
    return [serving.Request(
        rid=i, client=i % 4,
        prompt=rng.integers(1, vocab, rng.integers(2, 8)).tolist(),
        max_new=max_new) for i in range(n)]


def serve(srv: serving.BFCServer, reqs):
    """Submit every request (holding those of paused clients) and tick
    until all are done. Returns (done requests, wall seconds)."""
    t0 = time.perf_counter()
    pending, done = list(reqs), []
    while pending or srv.active or srv.pending:
        pending = [r for r in pending if not srv.submit(r)]
        done.extend(srv.tick())
    if srv.device.type == "cuda":
        torch.cuda.synchronize(srv.device)
    return done, time.perf_counter() - t0


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = configs.reduced(args.arch) if args.reduced else \
        configs.get(args.arch)
    params = model.init_model(cfg, device=dev)
    srv = serving.BFCServer(cfg, params, n_slots=args.slots,
                            max_len=args.max_len)
    done, dt = serve(srv, make_requests(cfg.vocab, args.requests,
                                        args.max_new))
    toks = sum(len(r.out) for r in done)
    print(f"[serve] {srv.stats.completed} requests, {toks} tokens in "
          f"{dt:.1f}s; pauses={srv.stats.pauses_sent} "
          f"resumes={srv.stats.resumes_sent}")
    return srv, done


if __name__ == "__main__":
    main()
