"""CUDA kernels of the BFC switch decision: build, bind and launch.

`csrc/bfc_step.cu` holds the kernels (one warp per port row; see the note
at the top of that file for what they replace and what bounds them). This
module compiles it with `nvcc` for `sm_90a` into a shared library with a
plain C interface at first use (`kernels.nvcc`), loads it with `ctypes`,
and wraps each entry point:

* `bfc_fused`  -- threshold + DRR/SRF pick + occupancy update, called once
  per simulated tick by `sim.phases.ctx.derive` (through `ops.fused`);
* `bfc_decide` -- the standalone threshold + DRR pick.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with `torch.empty`, launches on the current stream without
synchronising, raises if the launch returned a CUDA error, and adds one to
`launches[name]`. Nothing here runs at import time: the CPU tests import
this module on machines with no `nvcc` and no card.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import nvcc
from .ref import BIG, packed_sentinel

SOURCE = Path(__file__).resolve().parent / "csrc" / "bfc_step.cu"

# Kernel launches per entry point since the last `reset_launches()`.
launches = {"bfc_fused": 0, "bfc_decide": 0}

_lib = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def build() -> Path:
    """Compile `csrc/bfc_step.cu` (see `kernels.nvcc.build`)."""
    return nvcc.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.bfc_fused_launch.argtypes = ([vp] * 5 + [i] * 5 + [vp] * 6
                                         + [vp])
        lib.bfc_fused_launch.restype = i
        lib.bfc_decide_launch.argtypes = [vp] * 3 + [i] * 4 + [vp] * 4 + [vp]
        lib.bfc_decide_launch.restype = i
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(occ, qpaused, ptr):
    if not occ.is_cuda:
        raise ValueError(f"the BFC switch kernels take CUDA tensors; occ is "
                         f"on {occ.device}")
    if occ.dim() != 2:
        raise ValueError(f"occ must be (P, Q), got shape {tuple(occ.shape)}")
    p, q = occ.shape
    dev = occ.device
    _check("occ", occ, torch.int32, (p, q), dev)
    _check("qpaused", qpaused, torch.bool, (p, q), dev)
    _check("ptr", ptr, torch.int32, (p,), dev)
    return p, q, dev


def _err(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {code}")


def bfc_fused(occ, qpaused, ptr, blocked, *, pause_window: int,
              scheduler: str = "drr", srf_key=None):
    """Fused per-tick switch step on the card.

    occ (P,Q) i32, qpaused (P,Q) bool, ptr (P,) i32, blocked (P,) bool
    (PFC-paused or NIC ports -- excluded from the pick but not from
    N_active); srf_key (P,Q) i32, required iff scheduler == 'srf' and
    pre-clamped to `BIG` by the caller ->
    (n_active (P,), th (P,), pause_mask (P,Q) bool, sel_q (P,) i32
    (-1 = nothing eligible), can_tx (P,) bool, occ_after (P,Q) i32)."""
    p, q, dev = _check_common(occ, qpaused, ptr)
    _check("blocked", blocked, torch.bool, (p,), dev)
    if scheduler == "srf":
        if srf_key is None:
            raise ValueError("srf scheduler needs srf_key")
        _check("srf_key", srf_key, torch.int32, (p, q), dev)
        sentinel, key_ptr = packed_sentinel(q, BIG), srf_key.data_ptr()
    elif scheduler == "drr":
        sentinel, key_ptr = packed_sentinel(q, q - 1), None
    else:
        raise ValueError(f"unknown scheduler {scheduler!r}")
    i32 = dict(dtype=torch.int32, device=dev)
    n_act, th, sel = (torch.empty((p,), **i32) for _ in range(3))
    can_tx = torch.empty((p,), dtype=torch.bool, device=dev)
    pause = torch.empty((p, q), dtype=torch.bool, device=dev)
    occ_after = torch.empty((p, q), **i32)
    if p:
        lib = _load()
        _err("bfc_fused", lib.bfc_fused_launch(
            occ.data_ptr(), qpaused.data_ptr(), ptr.data_ptr(),
            blocked.data_ptr(), key_ptr, p, q, int(pause_window),
            int(scheduler == "srf"), sentinel, n_act.data_ptr(),
            th.data_ptr(), pause.data_ptr(), sel.data_ptr(),
            can_tx.data_ptr(), occ_after.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream))
        launches["bfc_fused"] += 1
    return n_act, th, pause, sel, can_tx, occ_after


def bfc_decide(occ, qpaused, ptr, *, pause_window: int):
    """Standalone threshold + DRR pick on the card: occ (P,Q) i32, qpaused
    (P,Q) bool, ptr (P,) i32 -> (n_active (P,), th (P,), pause_mask (P,Q)
    bool, sel_q (P,) i32)."""
    p, q, dev = _check_common(occ, qpaused, ptr)
    i32 = dict(dtype=torch.int32, device=dev)
    n_act, th, sel = (torch.empty((p,), **i32) for _ in range(3))
    pause = torch.empty((p, q), dtype=torch.bool, device=dev)
    if p:
        lib = _load()
        _err("bfc_decide", lib.bfc_decide_launch(
            occ.data_ptr(), qpaused.data_ptr(), ptr.data_ptr(), p, q,
            int(pause_window), packed_sentinel(q, q - 1), n_act.data_ptr(),
            th.data_ptr(), pause.data_ptr(), sel.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream))
        launches["bfc_decide"] += 1
    return n_act, th, pause, sel
