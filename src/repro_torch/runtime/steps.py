"""Prefill and decode steps: torch counterpart of the serving half
of `repro.runtime.steps` (training waits for a later slice).

The steps run eagerly under `torch.inference_mode` on the device the
parameters and tokens live on. The decode step updates the attention
cache in place (JAX donates it) and returns the new cache tree.
"""
from __future__ import annotations

import torch

from ..models import model
from ..models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, tokens):
        """tokens (B,S) -> (last-token logits (B,1,V) float32, cache with S
        positions). Every attention, RG-LRU and RWKV-6 layer runs its
        kernel."""
        b, s = tokens.shape
        with torch.inference_mode():
            cache = model.init_cache(cfg, b, s, device=tokens.device)
            hidden, cache = model.backbone(params, cfg, tokens, cache=cache,
                                           kv_len=s)
            return model.logits_for(params, cfg, hidden[:, -1:]), cache

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, cache, tokens, kv_len):
        """One new token per sequence, tokens (B,1), against a cache whose
        row r holds kv_len[r] (a (B,) tensor) valid positions."""
        with torch.inference_mode():
            hidden, cache = model.backbone(params, cfg, tokens, cache=cache,
                                           kv_len=kv_len + 1)
            return model.logits_for(params, cfg, hidden), cache

    return serve_step
