"""CUDA flash attention forward: build, bind and launch.

`csrc/flash_attention.cu` holds the kernels (see the note at the top of
that file for what they replace, what bounds them and their design): a
bfloat16 call launches the tensor-core kernel (wgmma fed by TMA), a
float32 call the CUDA-core kernel. The file is compiled with `nvcc` for
`sm_90a` at first use (`kernels.nvcc`) and loaded with `ctypes`.
`flash_attention` checks its operands, allocates the output, launches on
the current stream without synchronising, raises if the launch returned
an error, and adds one to `launches["flash_attention"]`. Nothing here
runs at import time.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 96, 128, 256)     # instances of both kernels
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ENCODE_ERROR = 10000   # launch codes from here on: 10000 + a CUresult

# Kernel launches since the last `reset_launches()`.
launches = {"flash_attention": 0}

_lib = None


def reset_launches() -> None:
    launches["flash_attention"] = 0


def build() -> Path:
    """Compile `csrc/flash_attention.cu` (see `kernels.nvcc.build`)."""
    return nvcc.build(SOURCE)


def tma_addressable(shape, strides, itemsize: int, ptr_mod16: int) -> bool:
    """Whether TMA can read a 4-d (batch, head, position, hd) operand with
    these element `strides` (head dim contiguous): a 16-byte-aligned base,
    and every stride of a dimension longer than 1 a multiple of 16 bytes
    below 2^40 (a dimension of length 1 is never stepped, and is handed to
    the tensor map with a stride of hd)."""
    if ptr_mod16 != 0 or strides[-1] != 1:
        return False
    return all(n == 1 or (st * itemsize % 16 == 0 and 0 < st * itemsize
                          < 1 << 40)
               for n, st in zip(shape[:-1], strides[:-1]))


def _strides(t):
    """(batch, head, position) element strides, length-1 dims set to hd."""
    return [st if n > 1 else t.shape[-1]
            for n, st in zip(t.shape[:3], t.stride()[:3])]


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_launch.argtypes = (
            [vp] * 4 + [ll] * 12 + [i] * 9 + [ctypes.c_float, vp])
        lib.flash_attention_launch.restype = i
        _lib = lib
    return _lib


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention takes CUDA tensors on one "
                             f"device; {name} is on {t.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, q has {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in head_dim")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes {list(DTYPES)}, got "
                        f"{q.dtype}")
    b, h, s, hd = q.shape
    _, kh, t, _ = k.shape
    if tuple(k.shape) != (b, kh, t, hd) or v.shape != k.shape:
        raise ValueError(f"k/v must be (B,K,T,hd) = ({b},K,T,{hd}); got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if kh == 0 or h % kh:
        raise ValueError(f"q heads {h} must be a multiple of kv heads {kh}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    return b, h, kh, s, t, hd


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B,H,S,hd), k/v (B,K,T,hd) -> (B,H,S,hd) in q's dtype (float32 or
    bfloat16; any strides with a contiguous head_dim, and for bfloat16
    TMA-addressable ones, see `tma_addressable`). The output is a
    (B,H,S,hd) view of a (B,S,H,hd) buffer, the layout the model's output
    projection reads."""
    b, h, kh, s, t, hd = _check(q, k, v)
    if t == 0 or (window > 0 and s - window >= t):
        raise ValueError(f"a query row would have no unmasked key (S={s}, "
                         f"T={t}, window={window})")
    if q.dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k), ("v", v)):
            if not tma_addressable(tuple(x.shape), x.stride(),
                                   x.element_size(), x.data_ptr() % 16):
                raise ValueError(
                    f"bf16 {name} {tuple(x.shape)} with strides {x.stride()}"
                    f" at {x.data_ptr():#x} is not TMA-addressable: the "
                    f"base must be 16-byte aligned and the strides "
                    f"multiples of 16 bytes")
    out = torch.empty((b, s, h, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    strides = [x for tt in (q, k, v, out) for x in _strides(tt)]
    err = _load().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
        b, h, kh, s, t, hd, DTYPES[q.dtype], int(causal), int(window),
        hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err >= ENCODE_ERROR:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled failed "
                           f"with CUresult {err - ENCODE_ERROR}")
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with "
                           f"cudaError_t {err}")
    launches["flash_attention"] += 1
    return out
