"""Plain torch versions of the BFC switch decision kernels: the CPU path of
`ops.derive` / `ops.fused` / `ops.decide` and the yardstick the CUDA
kernels are held against on the card. `bfc_fused_ref` and `bfc_decide_ref`
port `repro.kernels.bfc_step.ref`; `derive_ref` ports the simulator's
phase 0 (`repro.sim.phases.ctx.derive`), which feeds `bfc_fused`."""
from __future__ import annotations

from typing import NamedTuple

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


class DeriveOut(NamedTuple):
    """What `derive_ref` (and the kernel's derive mode) return; the field
    names are `sim.phases.ctx.StepCtx`'s."""
    occ: torch.Tensor          # (P, Q) i32 pre-tx occupancy
    port_occ: torch.Tensor     # (P,) i32
    sw_occ: torch.Tensor       # (NSW,) i32
    qpaused: torch.Tensor      # (P, Q) bool head-of-queue pause
    th: torch.Tensor           # (P,) i32 dynamic pause threshold
    pfc_paused: torch.Tensor   # (P,) bool
    rem_src: torch.Tensor      # (F,) i32 incl. this tick's arrivals
    ksel_q: torch.Tensor       # (P,) i32 DRR/SRF pick, -1 = none
    kcan_tx: torch.Tensor      # (P,) bool
    kocc_after: torch.Tensor   # (P, Q) i32 post-tx occupancy


def derive_ref(qhead, qtail, qbuf, qptr, qsrf, bloom_rx, ing_occ,
               pfc_paused, rem_src, fpos, arrival, size, port_switch,
               port_is_nic, feeds, buffer_limit, t, *, n_switches: int,
               lanes: int = 1, backpressure: bool, pfc: bool, scheduler: str,
               pfc_frac: float, pause_window: int) -> DeriveOut:
    """The simulator's per-tick switch step (phase 0).

    State: qhead, qtail, qsrf (P,Q) i32, qbuf (P,Q,CAP) i32 (entry =
    flow * 2 + mark, -1 empty), qptr (P,) i32, bloom_rx (P,S,B) bool,
    ing_occ (P,) i32, pfc_paused (P,) bool, rem_src (F,) i32, t () i32.
    Flows: fpos (F,S) i32 Bloom positions, arrival, size (F,) i32.
    Fabric: port_switch, feeds (P,) i32 (-1: none), port_is_nic (P,)
    bool, buffer_limit () i32, or (lanes,) when the lanes' fabrics differ.

    `lanes` fabrics laid side by side (`sim.phases.ctx`: lane k owns rows
    [k*P/lanes, ...), flows [k*F/lanes, ...) and switches [k*NSW/lanes,
    ...), and the ids in qbuf, port_switch and feeds are the batch's) are
    the same function on all rows: only the buffer limit, a non-NIC port
    that no switch owns and an empty head slot see the lane axis.

    Queue occupancy, per-port and per-switch buffer fill, the head-of-queue
    pause bits from the received Bloom snapshot, PFC hysteresis (pause
    above the fed switch's threshold, resume below half of it), this
    tick's flow arrivals at the sources --
    and the switch decision of `bfc_fused_ref` on them: PFC-paused and NIC
    ports are blocked."""
    p, q, cap = qbuf.shape
    dev = qhead.device
    occ = qtail - qhead                                    # (P, Q)
    port_occ = occ.sum(dim=1, dtype=I32)                   # (P,)
    # a non-NIC port that no switch owns adds to its lane's switch 0, and an
    # empty head slot reads its lane's flow 0, as the reference does within
    # each lane (never another lane's)
    owned = port_switch >= 0
    sw_occ = torch.zeros(n_switches, dtype=I32, device=dev).index_add(
        0, port_switch.clamp(min=0).long(),
        torch.where(port_is_nic | ~owned, 0, port_occ))    # (NSW,)
    sw_occ.view(lanes, -1)[:, 0] += torch.where(
        port_is_nic | owned, 0, port_occ).view(lanes, -1).sum(1, dtype=I32)

    head_entry = torch.gather(qbuf, 2,
                              (qhead % cap).long()[..., None])[..., 0]
    if backpressure:
        s = fpos.shape[1]
        head_pos = torch.where(
            (head_entry < 0).view(lanes, -1, q, 1),
            fpos.view(lanes, -1, s)[:, :1, None, :],
            fpos[(head_entry >> 1).clamp(min=0)].view(lanes, -1, q, s),
        ).view(p, q, s)                                          # (P, Q, S)
        got = bloom_rx[torch.arange(p, device=dev)[:, None, None],
                       torch.arange(s, device=dev)[None, None, :],
                       head_pos]                                 # (P, Q, S)
        qpaused = got.all(dim=-1) & (occ > 0)
    else:
        qpaused = torch.zeros((p, q), dtype=torch.bool, device=dev)

    if pfc:
        free_buf = (buffer_limit.reshape(-1, 1)
                    - sw_occ.view(lanes, -1)).clamp(min=0).view(-1)
        pfc_th = (pfc_frac * free_buf).to(I32).clamp(min=2)
        th_here = torch.where(feeds >= 0, pfc_th[feeds.clamp(min=0)],
                              1 << 30)
        pfc_now = torch.where(pfc_paused, ing_occ > th_here // 2,
                              ing_occ > th_here)
    else:
        pfc_now = torch.zeros((p,), dtype=torch.bool, device=dev)

    rem_src = rem_src + size * (arrival == t)

    blocked = pfc_now | port_is_nic
    srf_key = qsrf.clamp(max=BIG) if scheduler == "srf" else None
    _, th, _, ksel, kcan, kocc = bfc_fused_ref(
        occ, qpaused, qptr, blocked, srf_key=srf_key,
        pause_window=pause_window, scheduler=scheduler)
    return DeriveOut(occ=occ, port_occ=port_occ, sw_occ=sw_occ,
                     qpaused=qpaused, th=th, pfc_paused=pfc_now,
                     rem_src=rem_src, ksel_q=ksel, kcan_tx=kcan,
                     kocc_after=kocc)
