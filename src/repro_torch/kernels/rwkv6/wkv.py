"""CUDA RWKV-6 WKV recurrence: build, bind and launch.

`csrc/wkv.cu` holds the kernel (see the note at the top of that file for
what it replaces, what bounds it and its design). It is compiled with
`nvcc` for `sm_90a` at first use (`kernels.nvcc`) and loaded with
`ctypes`. `wkv` checks its operands, allocates the outputs, launches on
the current stream without synchronising, raises if the launch returned a
CUDA error, and adds one to `launches["wkv"]`. Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv.cu"
HEAD_DIMS = (16, 32, 64)                   # the kernel's template instances
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # r, k, v

# Kernel launches since the last `reset_launches()`.
launches = {"wkv": 0}

_lib = None


def reset_launches() -> None:
    launches["wkv"] = 0


def build() -> Path:
    """Compile `csrc/wkv.cu` (see `kernels.nvcc.build`)."""
    return nvcc.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.wkv_launch.argtypes = [vp] * 8 + [i] * 5 + [vp]
        lib.wkv_launch.restype = i
        _lib = lib
    return _lib


def _check(r, k, v, logw, u, h0):
    if r.dim() != 4:
        raise ValueError(f"r must be (B,S,H,D), got {tuple(r.shape)}")
    bsz, s, h, d = r.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"wkv: head_dim {d} has no kernel instance "
                         f"(have {HEAD_DIMS})")
    if r.dtype not in DTYPES:
        raise TypeError(f"r has dtype {r.dtype}, expected one of "
                        f"{tuple(DTYPES)}")
    f32 = torch.float32
    for name, t, shape, dtype in (
            ("r", r, (bsz, s, h, d), r.dtype), ("k", k, (bsz, s, h, d),
                                                r.dtype),
            ("v", v, (bsz, s, h, d), r.dtype), ("logw", logw, (bsz, s, h, d),
                                                f32),
            ("u", u, (h, d), f32), ("h0", h0, (bsz, h, d, d), f32)):
        if not t.is_cuda or t.device != r.device:
            raise ValueError(f"wkv takes CUDA tensors on one device; {name} "
                             f"is on {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"stages it in vector loads)")


def wkv(r, k, v, logw, u, h0):
    """r, k, v (B,S,H,D) float32 or bfloat16; logw (B,S,H,D), u (H,D),
    h0 (B,H,D,D) float32; all contiguous and 16-byte aligned on one CUDA
    device ->
    (out (B,S,H,D), hT (B,H,D,D)), float32."""
    _check(r, k, v, logw, u, h0)
    bsz, s, h, d = r.shape
    out = torch.empty((bsz, s, h, d), dtype=torch.float32, device=r.device)
    h_t = torch.empty((bsz, h, d, d), dtype=torch.float32, device=r.device)
    if s == 0:
        return out, h_t.copy_(h0)
    if h_t.numel() == 0:
        return out, h_t
    err = _load().wkv_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), h0.data_ptr(), out.data_ptr(), h_t.data_ptr(),
        bsz, s, h, d, DTYPES[r.dtype],
        torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv launch failed with cudaError_t {err}")
    launches["wkv"] += 1
    return out, h_t
