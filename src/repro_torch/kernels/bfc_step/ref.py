"""Plain torch versions of the BFC switch decision kernels: the CPU path of
`ops.fused` / `ops.decide` and the yardstick the CUDA kernels are held
against on the card. Port of `repro.kernels.bfc_step.ref`."""
from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32

# Largest priority key a packed DRR/SRF entry may carry. SRF state keys are
# clamped here before packing (the engine's `min(qsrf, BIG)`).
BIG = 1 << 20


def packed_sentinel(nq: int, max_key: int) -> int:
    """Smallest packed value strictly above every real (key, queue) pair.

    Packed priorities are ``key * nq + q_ix`` with key <= max_key and
    q_ix < nq, so ``(max_key + 1) * nq`` can never collide with a real
    entry. Raises if the packing would overflow int32."""
    sentinel = (max_key + 1) * nq
    if sentinel > np.iinfo(np.int32).max:
        raise ValueError(
            f"packed scheduler key overflows int32: nq={nq} max_key={max_key}")
    return sentinel


def _pick(elig, key, q, max_key):
    """(sel, can_tx): argmin of the packed key over eligible queues."""
    sentinel = packed_sentinel(q, max_key)
    q_ix = torch.arange(q, dtype=I32, device=key.device)[None, :]
    packed = torch.where(elig, key * q + q_ix, sentinel)
    best = packed.amin(dim=1)
    can_tx = best < sentinel
    return torch.where(can_tx, best % q, -1).to(I32), can_tx


def _threshold(occ, qpaused, pause_window: int):
    active = (occ > 0) & ~qpaused
    n_act = active.sum(dim=1, dtype=I32).clamp(min=1)
    th = (pause_window + n_act - 1) // n_act
    return active, n_act, th, occ > th[:, None]


def bfc_decide_ref(occ, qpaused, ptr, *, pause_window: int):
    """occ (P,Q) i32, qpaused (P,Q) bool, ptr (P,) i32 ->
    (n_active (P,), th (P,), pause_mask (P,Q) bool, sel_q (P,) i32)."""
    _, q = occ.shape
    active, n_act, th, pause = _threshold(occ, qpaused, pause_window)
    q_ix = torch.arange(q, dtype=I32, device=occ.device)[None, :]
    sel, _ = _pick(active, (q_ix - ptr[:, None]) % q, q, q - 1)
    return n_act, th, pause, sel


def bfc_fused_ref(occ, qpaused, ptr, blocked, *, pause_window: int,
                  scheduler: str = "drr", srf_key=None):
    """Threshold + DRR/SRF pick + occupancy update (see
    `bfc_step.bfc_fused` for the operand contract) ->
    (n_active, th, pause, sel_q, can_tx, occ_after)."""
    _, q = occ.shape
    active, n_act, th, pause = _threshold(occ, qpaused, pause_window)
    q_ix = torch.arange(q, dtype=I32, device=occ.device)[None, :]
    if scheduler == "srf":
        key, max_key = srf_key, BIG
    elif scheduler == "drr":
        key, max_key = (q_ix - ptr[:, None]) % q, q - 1
    else:
        raise ValueError(f"unknown scheduler {scheduler!r}")
    sel, can_tx = _pick(active & ~blocked[:, None], key, q, max_key)
    occ_after = occ - (can_tx[:, None] & (q_ix == sel[:, None])).to(I32)
    return n_act, th, pause, sel, can_tx, occ_after
