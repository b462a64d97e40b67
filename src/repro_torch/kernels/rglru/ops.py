"""Dispatch for the RG-LRU scan: the tensor's device picks the path.

A CUDA tensor launches the hand-written kernel (`rglru`), or the call
raises; a CPU tensor runs the plain torch version (`ref`). `launches`
counts kernel launches (the plain version counts none).
"""
from __future__ import annotations

from .. import on_card
from . import rglru as _kernel
from .rglru import launches, reset_launches  # noqa: F401
from .ref import rglru_scan_ref


def scan(log_a, b, h0):
    """h_t = exp(log_a_t) * h_{t-1} + b_t over (B,S,W) -> (h_all, h_last),
    float32."""
    if on_card(log_a, "RG-LRU scan"):
        return _kernel.rglru_scan(log_a, b, h0)
    return rglru_scan_ref(log_a, b, h0)
