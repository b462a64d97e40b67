"""Dispatch for attention: the tensor's device picks the path.

A CUDA tensor launches the hand-written kernel (`flash_attention`), or
the call raises; a CPU tensor runs the plain torch version (`ref`).
`launches` counts kernel launches (the plain version counts none).
"""
from __future__ import annotations

from .. import on_card
from . import flash_attention as _kernel
from .flash_attention import launches, reset_launches  # noqa: F401
from .ref import attention_ref


def attend(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B,H,S,hd), k/v (B,K,T,hd) -> (B,H,S,hd) in q's dtype."""
    if on_card(q, "attention"):
        return _kernel.flash_attention(q, k, v, causal=causal, window=window)
    return attention_ref(q, k, v, causal=causal, window=window)
