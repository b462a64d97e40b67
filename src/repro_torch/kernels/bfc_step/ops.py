"""Dispatch for the BFC switch decision: the tensor's device picks the path.

A CUDA tensor launches the hand-written kernel (`bfc_step`), or the call
raises; a CPU tensor runs the plain torch version (`ref`). There is no
fallback from one to the other and no environment override. `launches`
counts kernel launches per entry point (the plain version counts none);
`captured` counts those recorded into a CUDA graph under capture, which
the code that replays the graph adds per replay (`add_launches`).
"""
from __future__ import annotations

from .. import on_card
from . import bfc_step
from .bfc_step import (add_launches, captured, launches,  # noqa: F401
                       reset_captured, reset_launches)    # (re-export)
from .ref import bfc_decide_ref, bfc_fused_ref, derive_ref


def _on_card(t) -> bool:
    return on_card(t, "BFC switch-step")


def decide(occ, qpaused, ptr, *, pause_window: int):
    """Threshold + DRR pick: see `bfc_step.bfc_decide`."""
    if _on_card(occ):
        return bfc_step.bfc_decide(occ, qpaused, ptr,
                                   pause_window=pause_window)
    return bfc_decide_ref(occ, qpaused, ptr, pause_window=pause_window)


def fused(occ, qpaused, ptr, blocked, *, pause_window: int,
          scheduler: str = "drr", srf_key=None):
    """The engine's fused switch step (threshold + DRR/SRF pick + occupancy
    update); see `bfc_step.bfc_fused` for the operand contract."""
    if _on_card(occ):
        return bfc_step.bfc_fused(occ, qpaused, ptr, blocked,
                                  pause_window=pause_window,
                                  scheduler=scheduler, srf_key=srf_key)
    return bfc_fused_ref(occ, qpaused, ptr, blocked,
                         pause_window=pause_window, scheduler=scheduler,
                         srf_key=srf_key)


def derive(qhead, *args, **kwargs):
    """The simulator's per-tick switch step (state -> `ref.DeriveOut`); see
    `ref.derive_ref` for the operand contract. On the card one launch of
    the kernel, counted as `bfc_fused`'s."""
    if _on_card(qhead):
        return bfc_step.derive(qhead, *args, **kwargs)
    return derive_ref(qhead, *args, **kwargs)
