"""CUDA RG-LRU scan: build, bind and launch.

`csrc/rglru.cu` holds the kernel (see the note at the top of that file).
It is compiled with `nvcc` for `sm_90a` at first use (`kernels.nvcc`) and
loaded with `ctypes`. `rglru_scan` checks its operands, allocates the
outputs, launches on the current stream without synchronising, raises if
the launch returned a CUDA error, and adds one to
`launches["rglru_scan"]`. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru.cu"

# Kernel launches since the last `reset_launches()`.
launches = {"rglru_scan": 0}

_lib = None


def reset_launches() -> None:
    launches["rglru_scan"] = 0


def build() -> Path:
    """Compile `csrc/rglru.cu` (see `kernels.nvcc.build`)."""
    return nvcc.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.rglru_scan_launch.argtypes = [vp] * 5 + [i] * 3 + [vp]
        lib.rglru_scan_launch.restype = i
        _lib = lib
    return _lib


def rglru_scan(log_a, b, h0):
    """log_a, b (B,S,W), h0 (B,W), all float32 and contiguous on one CUDA
    device -> (h_all (B,S,W), h_last (B,W)), float32."""
    if log_a.dim() != 3:
        raise ValueError(f"log_a must be (B,S,W), got {tuple(log_a.shape)}")
    bsz, s, w = log_a.shape
    for name, t, shape in (("log_a", log_a, (bsz, s, w)),
                           ("b", b, (bsz, s, w)), ("h0", h0, (bsz, w))):
        if not t.is_cuda or t.device != log_a.device:
            raise ValueError(f"rglru_scan takes CUDA tensors on one device; "
                             f"{name} is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    h_all = torch.empty((bsz, s, w), dtype=torch.float32,
                        device=log_a.device)
    h_last = torch.empty((bsz, w), dtype=torch.float32, device=log_a.device)
    if s == 0:
        return h_all, h_last.copy_(h0)
    if h_last.numel() == 0:
        return h_all, h_last
    err = _load().rglru_scan_launch(
        log_a.data_ptr(), b.data_ptr(), h0.data_ptr(), h_all.data_ptr(),
        h_last.data_ptr(), bsz, s, w,
        torch.cuda.current_stream(log_a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed with cudaError_t "
                           f"{err}")
    launches["rglru_scan"] += 1
    return h_all, h_last
