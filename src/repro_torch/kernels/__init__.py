"""Hand-written CUDA kernels of the port, each beside its plain torch
version: `bfc_step` (the simulator's per-tick switch decision),
`flash_attention` (the LM's prefill attention), `rglru` (the LM's RG-LRU
recurrence) and `rwkv6` (the LM's RWKV-6 WKV recurrence). `nvcc` builds
them at first use."""
from __future__ import annotations


def on_card(t, what: str) -> bool:
    """The path a kernel's dispatcher takes for tensor `t`: True for a CUDA
    tensor (launch the kernel, or raise), False for a CPU tensor (the plain
    torch version). There is no fallback from one to the other."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no {what} path for device {t.device}")
