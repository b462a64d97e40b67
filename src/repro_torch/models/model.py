"""The composable decoder: torch counterpart of `repro.models.model`, for
the block kinds the port covers ('attn', 'local', 'rec', 'rwkv') with
dense MLPs (or the RWKV channel mix on 'rwkv' blocks) and standard (or
no) rope.

Layers are grouped into repeated pattern units (e.g. recurrentgemma:
rec, rec, local). JAX stacks the units and scans over them; here the
units are a `ModuleList` and `backbone` is a plain Python loop over them,
with the remainder blocks (`rem_i`) after. Parameter names mirror the JAX
tree paths (see `models.nn`).
"""
from __future__ import annotations

import torch

from .. import resolve_device
from . import attention, layers, rglru, rwkv6
from .config import ModelConfig
from .nn import Initializer, Params

SUPPORTED_BLOCKS = ("attn", "local", "rec", "rwkv")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what this slice of the port does not
    build yet (it never falls back to something else)."""
    missing = []
    if cfg.is_moe:
        missing.append("MoE feed-forward")
    missing += [f"'{k}' blocks" for k in sorted(set(cfg.pattern))
                if k not in SUPPORTED_BLOCKS]
    if cfg.rope not in ("standard", "none"):
        missing.append(f"'{cfg.rope}' rope")
    if cfg.frontend != "none":
        missing.append(f"the '{cfg.frontend}' frontend")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port does not implement "
            f"{', '.join(missing)} yet")


# ---- init --------------------------------------------------------------------
def _init_block(ini: Initializer, cfg: ModelConfig, kind: str):
    layers.init_rmsnorm(ini, "norm1", cfg.d_model)
    layers.init_rmsnorm(ini, "norm2", cfg.d_model)
    mixer = ini.scope("mixer")
    if kind in ("attn", "local"):
        attention.init_attention(mixer, cfg)
    elif kind == "rec":
        rglru.init_rglru(mixer, cfg)
    else:
        rwkv6.init_rwkv(mixer, cfg)
    ffn = ini.scope("ffn")
    if kind == "rwkv":
        rwkv6.init_rwkv_cm(ffn, cfg)
    else:
        layers.init_mlp(ffn, cfg)


def init_model(cfg: ModelConfig, *, device="cuda",
               generator: torch.Generator | None = None,
               seed: int = 0) -> Params:
    """The parameter tree on `device` (the card unless "cpu" is asked
    for), drawn from `generator` (a `torch.Generator` on that device; one
    seeded with `seed` if none is given)."""
    check_supported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(seed)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    root = Params()
    ini = Initializer(root, generator, cfg.param_dtype)
    layers.init_embed(ini, cfg)
    layers.init_rmsnorm(ini, "final_norm", cfg.d_model)
    n_full, rem = cfg.layer_plan
    root.units = torch.nn.ModuleList()
    for _ in range(n_full):
        unit = Params()
        uini = Initializer(unit, generator, cfg.param_dtype)
        for j, kind in enumerate(cfg.pattern):
            _init_block(uini.scope(f"b{j}"), cfg, kind)
        root.units.append(unit)
    for i, kind in enumerate(rem):
        _init_block(ini.scope(f"rem_{i}"), cfg, kind)
    return root


# ---- cache --------------------------------------------------------------------
def _block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 dtype, device):
    z = dict(dtype=dtype, device=device)
    if kind in ("attn", "local"):
        kv = (batch, max_len, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(kv, **z), "v": torch.zeros(kv, **z)}
    if kind == "rec":
        return {"h": torch.zeros((batch, cfg.rnn_w), **z),
                "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.rnn_w),
                                    **z)}
    hd = cfg.rwkv_head_dim
    return {"S": torch.zeros((batch, cfg.d_model // hd, hd, hd), **z),
            "shift": torch.zeros((batch, cfg.d_model), **z),
            "shift_cm": torch.zeros((batch, cfg.d_model), **z)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """The decode cache: {"units": [per-unit {"b0": ..., ...}], "rem_i":
    ...}, in the compute dtype (JAX's `stacked=False` layout; the test
    converter maps JAX's stacked prefill layout onto it)."""
    check_supported(cfg)
    dev = resolve_device(device)
    n_full, rem = cfg.layer_plan
    args = (batch, max_len, cfg.compute_dtype, dev)
    cache = {"units": [{f"b{j}": _block_cache(cfg, k, *args)
                        for j, k in enumerate(cfg.pattern)}
                       for _ in range(n_full)]}
    for i, kind in enumerate(rem):
        cache[f"rem_{i}"] = _block_cache(cfg, kind, *args)
    return cache


# ---- forward ------------------------------------------------------------------
def _apply_block(bp, cfg: ModelConfig, kind: str, x, cos_sin, cache, kv_len):
    h = layers.rmsnorm(bp["norm1"], x)
    if kind in ("attn", "local"):
        window = cfg.window if kind == "local" else 0
        mix, new_cache = attention.attention_block(
            bp["mixer"], cfg, h, cos_sin=cos_sin, window=window, cache=cache,
            kv_len=kv_len)
    elif kind == "rec":
        mix, new_cache = rglru.rglru_block(bp["mixer"], cfg, h, cache=cache)
    else:
        sub = ({"shift": cache["shift"], "S": cache["S"]}
               if cache is not None else None)
        mix, new_cache = rwkv6.rwkv_time_mix(bp["mixer"], cfg, h, cache=sub)
    x = x + mix
    h = layers.rmsnorm(bp["norm2"], x)
    if kind != "rwkv":
        return x + layers.mlp(bp["ffn"], cfg, h), new_cache
    cm_cache = {"shift": cache["shift_cm"]} if cache is not None else None
    f, cmc = rwkv6.rwkv_channel_mix(bp["ffn"], cfg, h, cache=cm_cache)
    if new_cache is not None:
        new_cache["shift_cm"] = cmc["shift"]
    return x + f, new_cache


def _positions(batch: int, s: int, kv_len, device):
    ar = torch.arange(s, device=device)[None, :]
    if kv_len is None:
        return ar.repeat(batch, 1)
    kv = torch.as_tensor(kv_len, device=device)
    if kv.dim() == 1:                      # per-row lengths (serving)
        return (kv[:, None] - s) + ar
    return (kv - s) + ar.repeat(batch, 1)


def backbone(params, cfg: ModelConfig, tokens, *, cache=None, kv_len=None):
    """tokens (B,S) -> (final hidden states (B,S,d), new_cache). With a
    cache, kv_len is the valid length including these tokens (int, or a
    (B,) tensor for per-row serving lengths)."""
    b, s = tokens.shape
    x = layers.embed(params, cfg, tokens)
    pos = _positions(b, s, kv_len, tokens.device)
    cos_sin = (layers.rope_angles(pos, cfg.hd, cfg.rope_theta)
               if cfg.rope == "standard" else None)
    n_full, rem = cfg.layer_plan
    new_cache = {"units": []} if cache is not None else None
    for i in range(n_full):
        up = params["units"][i]
        uc = cache["units"][i] if cache is not None else None
        new_unit = {}
        for j, kind in enumerate(cfg.pattern):
            c = uc[f"b{j}"] if uc is not None else None
            x, new_unit[f"b{j}"] = _apply_block(up[f"b{j}"], cfg, kind, x,
                                                cos_sin, c, kv_len)
        if cache is not None:
            new_cache["units"].append(new_unit)
    for i, kind in enumerate(rem):
        c = cache[f"rem_{i}"] if cache is not None else None
        x, nc = _apply_block(params[f"rem_{i}"], cfg, kind, x, cos_sin, c,
                             kv_len)
        if cache is not None:
            new_cache[f"rem_{i}"] = nc
    return layers.rmsnorm(params["final_norm"], x), new_cache


def logits_for(params, cfg: ModelConfig, hidden):
    return layers.unembed(params, cfg, hidden).float()
