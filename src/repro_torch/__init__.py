"""PyTorch/CUDA port of the BFC packet-level simulator.

A second package beside `repro` (the JAX reference): it mirrors `repro`'s
module names, imports `torch` and numpy only, and never imports `jax` or
anything of `repro`. The per-tick switch decision runs as a hand-written
CUDA kernel for Hopper (`kernels/bfc_step`); the rest of the tick is
plain torch ops on the device the operands live on.

Entry points run on the card unless the caller passes ``device="cpu"``;
asking for CUDA where there is none raises (see `resolve_device`).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on. Never falls back: a CUDA
    request on a machine without a usable card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain torch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
