"""Shared layers: norms, embeddings, rotary embedding, MLPs (torch
counterpart of `repro.models.layers`; the `mrope` and `sinusoidal`
variants are not ported yet).

Dtype promotion follows JAX's: rope multiplies the compute-dtype
activations by float32 angles and casts the result back; `jax.nn.gelu`
defaults to the tanh approximation, so `gelu` here is
`F.gelu(approximate="tanh")`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .nn import Initializer


# ---- norms -------------------------------------------------------------------
def init_rmsnorm(ini: Initializer, name: str, dim: int):
    ini.param(name, (dim,), init="ones")


def rmsnorm(w, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


# ---- rotary embeddings ---------------------------------------------------------
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, head_dim//2)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (B,S,H,hd); cos/sin (B,S,hd/2) or (S,hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---- dense / gated MLP ---------------------------------------------------------
def init_mlp(ini: Initializer, cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.gated:
        ini.param("wi_gate", (d, f), init="fan_in")
    ini.param("wi", (d, f), init="fan_in")
    ini.param("wo", (f, d), init="fan_in")


def gelu(x):
    """`jax.nn.gelu`'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _act(cfg: ModelConfig, x):
    if cfg.act == "swiglu":
        return F.silu(x)
    if cfg.act in ("geglu", "gelu"):
        return gelu(x)
    if cfg.act == "relu2":
        return torch.square(F.relu(x))
    raise ValueError(cfg.act)


def mlp(p, cfg: ModelConfig, x):
    h = x @ p["wi"]
    if cfg.gated:
        h = _act(cfg, x @ p["wi_gate"]) * h
    else:
        h = _act(cfg, h)
    return h @ p["wo"]


# ---- embedding ----------------------------------------------------------------
def init_embed(ini: Initializer, cfg: ModelConfig):
    # N(0, 1/d): combined with the sqrt(d) input multiplier this gives unit
    # variance inputs AND sane tied-logit magnitudes at init
    ini.param("embedding", (cfg.vocab, cfg.d_model), init="normal",
              scale=cfg.d_model ** -0.5)
    if not cfg.tie_embeddings:
        ini.param("head", (cfg.d_model, cfg.vocab), init="fan_in")


def embed(p, cfg: ModelConfig, tokens: torch.Tensor):
    x = p["embedding"][tokens].to(cfg.compute_dtype)
    return x * math.sqrt(cfg.d_model)


def unembed(p, cfg: ModelConfig, x: torch.Tensor):
    if cfg.tie_embeddings:
        return x @ p["embedding"].T.to(cfg.compute_dtype)
    return x @ p["head"].to(cfg.compute_dtype)
