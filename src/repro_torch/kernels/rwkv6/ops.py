"""Dispatch for the RWKV-6 WKV recurrence: the tensor's device picks the
path.

A CUDA tensor launches the hand-written kernel (`wkv`), or the call
raises; a CPU tensor runs the plain torch version (`ref`). `launches`
counts kernel launches (the plain version counts none).
"""
from __future__ import annotations

from .. import on_card
from . import wkv as _kernel
from .ref import wkv_chunked_ref
from .wkv import launches, reset_launches  # noqa: F401


def wkv(r, k, v, logw, u, h0):
    """The WKV recurrence over (B,S,H,D) from state h0 (B,H,D,D) ->
    (out (B,S,H,D), hT (B,H,D,D)), float32."""
    if on_card(r, "WKV"):
        return _kernel.wkv(r, k, v, logw, u, h0)
    return wkv_chunked_ref(r, k, v, logw, u, h0)
