"""Architecture registry: the 10 assigned configs + reduced smoke variants
(torch counterpart of `repro.configs`; the arch files are data).

The port builds only what its slices cover; `models.model.init_model`
raises `NotImplementedError` for MoE, `mrope`/`sinusoidal` rope and
modality frontends."""
from __future__ import annotations

from typing import Dict

import torch

from ..models.config import ModelConfig
from . import (deepseek_67b, gemma3_1b, granite_moe_1b, grok1_314b,
               musicgen_medium, phi3_mini_3_8b, qwen2_vl_2b,
               recurrentgemma_2b, rwkv6_3b, starcoder2_15b)
from .shapes import SHAPES, LONG_CONTEXT_ARCHS, ShapeSpec, cells  # noqa: F401

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (
        granite_moe_1b, grok1_314b, phi3_mini_3_8b, deepseek_67b,
        starcoder2_15b, gemma3_1b, qwen2_vl_2b, musicgen_medium,
        recurrentgemma_2b, rwkv6_3b)
}


def get(name: str) -> ModelConfig:
    return ARCHS[name]


def reduced(name: str) -> ModelConfig:
    """Small same-family config for CPU smoke tests: few layers (but >= one
    full pattern unit), narrow width, tiny vocab, few experts."""
    cfg = ARCHS[name]
    unit = len(cfg.pattern)
    heads = min(cfg.n_heads, 4)
    kv = min(cfg.n_kv_heads, heads)
    d = 64
    hd = d // heads if cfg.head_dim == 0 else 32
    kw = dict(
        n_layers=max(unit + 1, 3) if unit > 1 else 2,
        d_model=d, n_heads=heads, n_kv_heads=kv, d_ff=128,
        head_dim=hd if cfg.head_dim else 0,
        vocab=512, frontend_tokens=8, window=min(cfg.window, 16) or 0,
        rnn_width=d if cfg.rnn_width else 0,
        rwkv_head_dim=16,
    )
    if cfg.is_moe:
        # high capacity factor: tiny-seq tests should not hit capacity drops
        kw.update(n_experts=4, top_k=2, capacity_factor=4.0)
    kw.update(param_dtype=torch.float32, compute_dtype=torch.float32)
    return cfg.with_(**kw)
