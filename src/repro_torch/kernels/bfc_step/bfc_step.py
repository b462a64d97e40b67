"""CUDA kernels of the BFC switch decision: build, bind and launch.

`csrc/bfc_step.cu` holds one kernel body in three modes (see the note at
the top of that file for what they replace and what bounds them). This
module compiles it with `nvcc` for `sm_90a` into a shared library with a
plain C interface at first use (`kernels.nvcc`), loads it with `ctypes`,
and wraps each entry point:

* `derive`     -- the simulator's per-tick switch step: occupancy, the
  head-of-queue Bloom lookup, PFC, the arrivals at the sources and the
  threshold + DRR/SRF pick + occupancy update of `bfc_fused`, from the
  state in one launch; called once per simulated tick by
  `sim.phases.ctx.derive` (through `ops.derive`). Its launches count as
  `bfc_fused`'s: it is the main path's counterpart of that TPU kernel;
* `bfc_fused`  -- the TPU kernel's own contract: threshold + DRR/SRF pick
  + occupancy update from given occupancy and pause bits;
* `bfc_decide` -- the standalone threshold + DRR pick.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with `torch.empty`, launches on the current stream without
synchronising, raises if the launch returned a CUDA error, and adds one to
`launches[name]` -- or, while the stream is being captured into a CUDA
graph, to `captured[name]`: a replay of the graph launches the kernel
without this wrapper, so whoever replays it adds the captured count to
`launches` per replay (`add_launches`). Nothing here runs at import time:
the CPU tests import this module on machines with no `nvcc` and no card.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import nvcc
from .ref import BIG, DeriveOut, packed_sentinel

SOURCE = Path(__file__).resolve().parent / "csrc" / "bfc_step.cu"

# Kernel launches per entry point since the last `reset_launches()`, and
# launches recorded into a CUDA graph under capture since the last
# `reset_captured()`.
launches = {"bfc_fused": 0, "bfc_decide": 0}
captured = {"bfc_fused": 0, "bfc_decide": 0}

MODES = {"bfc_decide": 0, "bfc_fused": 1, "derive": 2}
CLUSTER_BLOCKS = 8                 # csrc: kClusterBlocks
SMEM_LIMIT = 48 * 1024             # a block's shared memory without opt-in

_lib = None


class _Params(ctypes.Structure):
    """Mirror of `struct Params` in csrc/bfc_step.cu, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "occ", "qpaused", "ptr", "blocked", "srf_key",
        "qhead", "qtail", "qbuf", "qsrf", "bloom_rx", "ing_occ", "pfc_prev",
        "rem_src", "fpos", "arrival", "size", "port_switch", "port_is_nic",
        "feeds", "buffer_limit", "t",
        "o_nact", "o_th", "o_pause", "o_sel", "o_cantx", "o_occ_after",
        "o_occ", "o_port_occ", "o_sw_occ", "o_qpaused", "o_pfc",
        "o_rem_src")]
        + [(n, ctypes.c_int) for n in (
            "n_rows", "nq", "rows_per_block", "pause_window", "sentinel",
            "cap", "n_stages", "stage_bits", "n_switches", "n_flows",
            "backpressure", "pfc")]
        + [("pfc_frac", ctypes.c_float)])


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def reset_captured() -> None:
    for name in captured:
        captured[name] = 0


def add_launches(counts: dict) -> None:
    """Count the launches of one replay of a captured graph (`counts` is
    `captured` as it stood when the capture ended)."""
    for name, n in counts.items():
        launches[name] += n


def _count(name: str) -> None:
    (captured if torch.cuda.is_current_stream_capturing()
     else launches)[name] += 1


def build() -> Path:
    """Compile `csrc/bfc_step.cu` (see `kernels.nvcc.build`)."""
    return nvcc.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.bfc_step_launch.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.POINTER(_Params),
                                        ctypes.c_void_p]
        lib.bfc_step_launch.restype = ctypes.c_int
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


def _on_cuda(what: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"the BFC switch kernels take CUDA tensors; {what} "
                         f"is on {t.device}")


def _check_common(occ, qpaused, ptr):
    _on_cuda("occ", occ)
    if occ.dim() != 2:
        raise ValueError(f"occ must be (P, Q), got shape {tuple(occ.shape)}")
    p, q = occ.shape
    dev = occ.device
    _check("occ", occ, torch.int32, (p, q), dev)
    _check("qpaused", qpaused, torch.bool, (p, q), dev)
    _check("ptr", ptr, torch.int32, (p,), dev)
    return p, q, dev


def _sentinel(scheduler: str, q: int) -> int:
    if scheduler == "srf":
        return packed_sentinel(q, BIG)
    if scheduler == "drr":
        return packed_sentinel(q, q - 1)
    raise ValueError(f"unknown scheduler {scheduler!r}")


def _launch(name: str, mode: str, srf: bool, dev, **fields) -> None:
    """Fill `_Params` (tensors by pointer) and launch on the current
    stream."""
    params = _Params(**{k: (v.data_ptr() if isinstance(v, torch.Tensor)
                            else v) for k, v in fields.items()})
    code = _load().bfc_step_launch(MODES[mode], int(srf),
                                   ctypes.byref(params),
                                   torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {code}")
    _count(name)


def bfc_fused(occ, qpaused, ptr, blocked, *, pause_window: int,
              scheduler: str = "drr", srf_key=None):
    """Fused switch step on the card (the TPU kernel's contract).

    occ (P,Q) i32, qpaused (P,Q) bool, ptr (P,) i32, blocked (P,) bool
    (PFC-paused or NIC ports -- excluded from the pick but not from
    N_active); srf_key (P,Q) i32, required iff scheduler == 'srf' and
    pre-clamped to `BIG` by the caller ->
    (n_active (P,), th (P,), pause_mask (P,Q) bool, sel_q (P,) i32
    (-1 = nothing eligible), can_tx (P,) bool, occ_after (P,Q) i32)."""
    p, q, dev = _check_common(occ, qpaused, ptr)
    _check("blocked", blocked, torch.bool, (p,), dev)
    sentinel = _sentinel(scheduler, q)
    if scheduler == "srf":
        if srf_key is None:
            raise ValueError("srf scheduler needs srf_key")
        _check("srf_key", srf_key, torch.int32, (p, q), dev)
    i32 = dict(dtype=torch.int32, device=dev)
    n_act, th, sel = (torch.empty((p,), **i32) for _ in range(3))
    can_tx = torch.empty((p,), dtype=torch.bool, device=dev)
    pause = torch.empty((p, q), dtype=torch.bool, device=dev)
    occ_after = torch.empty((p, q), **i32)
    if p:
        _launch("bfc_fused", "bfc_fused", scheduler == "srf", dev,
                occ=occ, qpaused=qpaused, ptr=ptr, blocked=blocked,
                srf_key=srf_key if scheduler == "srf" else None,
                o_nact=n_act, o_th=th, o_pause=pause, o_sel=sel,
                o_cantx=can_tx, o_occ_after=occ_after, n_rows=p, nq=q,
                pause_window=int(pause_window), sentinel=sentinel)
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
        _launch("bfc_decide", "bfc_decide", False, dev,
                occ=occ, qpaused=qpaused, ptr=ptr, o_nact=n_act, o_th=th,
                o_pause=pause, o_sel=sel, n_rows=p, nq=q,
                pause_window=int(pause_window),
                sentinel=packed_sentinel(q, q - 1))
    return n_act, th, pause, sel


def derive(qhead, qtail, qbuf, qptr, qsrf, bloom_rx, ing_occ, pfc_paused,
           rem_src, fpos, arrival, size, port_switch, port_is_nic, feeds,
           buffer_limit, t, *, n_switches: int, backpressure: bool,
           pfc: bool, scheduler: str, pfc_frac: float,
           pause_window: int) -> DeriveOut:
    """The simulator's per-tick switch step on the card, in one launch: see
    `ref.derive_ref` for the operand contract. Its launch counts as
    `bfc_fused`'s."""
    _on_cuda("qhead", qhead)
    if qbuf.dim() != 3 or fpos.dim() != 2 or bloom_rx.dim() != 3:
        raise ValueError("qbuf (P,Q,CAP), bloom_rx (P,S,B) and fpos (F,S) "
                         "expected")
    p, q, cap = qbuf.shape
    f, s = fpos.shape
    b = bloom_rx.shape[2]
    dev = qhead.device
    i32, u8 = torch.int32, torch.bool
    for name, x, dtype, shape in (
            ("qhead", qhead, i32, (p, q)), ("qtail", qtail, i32, (p, q)),
            ("qbuf", qbuf, i32, (p, q, cap)), ("qptr", qptr, i32, (p,)),
            ("qsrf", qsrf, i32, (p, q)), ("bloom_rx", bloom_rx, u8, (p, s, b)),
            ("ing_occ", ing_occ, i32, (p,)), ("pfc_paused", pfc_paused, u8,
                                              (p,)),
            ("rem_src", rem_src, i32, (f,)), ("fpos", fpos, i32, (f, s)),
            ("arrival", arrival, i32, (f,)), ("size", size, i32, (f,)),
            ("port_switch", port_switch, i32, (p,)),
            ("port_is_nic", port_is_nic, u8, (p,)), ("feeds", feeds, i32,
                                                     (p,)),
            ("buffer_limit", buffer_limit, i32, ()), ("t", t, i32, ())):
        _check(name, x, dtype, shape, dev)
    rows = -(-p // CLUSTER_BLOCKS)
    if 4 * (3 * rows + 2 * n_switches) > SMEM_LIMIT:
        raise ValueError(f"{p} ports and {n_switches} switches do not fit "
                         f"a block's {SMEM_LIMIT} bytes of shared memory")
    sentinel = _sentinel(scheduler, q)
    out = DeriveOut(
        occ=torch.empty((p, q), dtype=i32, device=dev),
        port_occ=torch.empty((p,), dtype=i32, device=dev),
        sw_occ=torch.empty((n_switches,), dtype=i32, device=dev),
        qpaused=torch.empty((p, q), dtype=u8, device=dev),
        th=torch.empty((p,), dtype=i32, device=dev),
        pfc_paused=torch.empty((p,), dtype=u8, device=dev),
        rem_src=torch.empty((f,), dtype=i32, device=dev),
        ksel_q=torch.empty((p,), dtype=i32, device=dev),
        kcan_tx=torch.empty((p,), dtype=u8, device=dev),
        kocc_after=torch.empty((p, q), dtype=i32, device=dev))
    if p:
        _launch("bfc_fused", "derive", scheduler == "srf", dev,
                ptr=qptr, qhead=qhead, qtail=qtail, qbuf=qbuf, qsrf=qsrf,
                bloom_rx=bloom_rx, ing_occ=ing_occ, pfc_prev=pfc_paused,
                rem_src=rem_src, fpos=fpos, arrival=arrival, size=size,
                port_switch=port_switch, port_is_nic=port_is_nic,
                feeds=feeds, buffer_limit=buffer_limit, t=t,
                o_th=out.th, o_sel=out.ksel_q, o_cantx=out.kcan_tx,
                o_occ_after=out.kocc_after, o_occ=out.occ,
                o_port_occ=out.port_occ, o_sw_occ=out.sw_occ,
                o_qpaused=out.qpaused, o_pfc=out.pfc_paused,
                o_rem_src=out.rem_src, n_rows=p, nq=q,
                pause_window=int(pause_window), sentinel=sentinel, cap=cap,
                n_stages=s, stage_bits=b, n_switches=int(n_switches),
                n_flows=f, backpressure=int(bool(backpressure)),
                pfc=int(bool(pfc)), pfc_frac=float(pfc_frac))
    return out
