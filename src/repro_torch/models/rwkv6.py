"""RWKV-6 "Finch" block (arXiv:2404.05892): attention-free time mix with
data-dependent per-channel decay, plus the RWKV channel mix; torch
counterpart of `repro.models.rwkv6`.

Per head (head_dim D), with state S (D x D):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)          (u = "bonus")

w_t = exp(-exp(wx_t)) in (0,1) is data-dependent (LoRA on the shifted
input). Over more than one token the recurrence runs through
`kernels.rwkv6.ops.wkv` (the CUDA kernel on the card, the chunked form on
the CPU); a single decode step stays plain torch, as in `models.rglru`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.rwkv6 import ops
from ..kernels.rwkv6.ref import wkv_step
from .config import ModelConfig
from .nn import Initializer


def init_rwkv(ini: Initializer, cfg: ModelConfig):
    d = cfg.d_model
    lora = 64
    for nm in ("r", "k", "v", "g"):
        ini.param(f"w_{nm}", (d, d), init="fan_in")
    ini.param("w_o", (d, d), init="fan_in")
    ini.param("mu", (5, d), init="uniform", scale=0.5)
    ini.param("w_decay_a", (d, lora), init="fan_in")
    ini.param("w_decay_b", (lora, d), init="fan_in")
    ini.param("decay_base", (d,), init="uniform", scale=1.0)
    ini.param("bonus", (d,), init="uniform", scale=0.5)


def init_rwkv_cm(ini: Initializer, cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    ini.param("mu_k", (d,), init="uniform", scale=0.5)
    ini.param("w_k", (d, f), init="fan_in")
    ini.param("w_v", (f, d), init="fan_in")


def _shift(x, prev):
    """Token shift: x_{t-1} with `prev` (B,d) as the t=0 predecessor."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _prev(x, cache):
    b, _, d = x.shape
    return (cache["shift"] if cache is not None
            else torch.zeros((b, d), dtype=x.dtype, device=x.device))


def rwkv_time_mix(p, cfg: ModelConfig, x, *, cache=None):
    """x (B,S,d) -> (out, new_cache). cache = {'shift': (B,d), 'S':
    (B,H,D,D)}."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    nh = d // hd
    xs = _shift(x, _prev(x, cache))
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (x + mu[i] * (xs - x) for i in range(5))
    r = (xr @ p["w_r"]).reshape(b, s, nh, hd)
    k = (xk @ p["w_k"]).reshape(b, s, nh, hd)
    v = (xv @ p["w_v"]).reshape(b, s, nh, hd)
    g = F.silu(xg @ p["w_g"])
    # data-dependent decay, log w <= 0 by construction
    wx = p["decay_base"].float() \
        + ((xw @ p["w_decay_a"]) @ p["w_decay_b"]).float()
    # clip so log w in [-5, 0): keeps the chunked evaluation overflow-free
    logw = -torch.clamp(torch.exp(torch.clamp(wx, -10.0, 1.6)), 1e-6, 5.0)
    logw = logw.reshape(b, s, nh, hd)
    u = p["bonus"].float().reshape(nh, hd)

    h0 = (cache["S"].float() if cache is not None
          else torch.zeros((b, nh, hd, hd), dtype=torch.float32,
                           device=x.device))
    if s == 1:
        out, h_t = wkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u, h0)
        out = out[:, None]
    else:
        assert s % min(16, s) == 0, f"s={s} is not a multiple of 16"
        out, h_t = ops.wkv(r, k, v, logw, u, h0)
    out = out.to(r.dtype).reshape(b, s, d) * g
    out = out @ p["w_o"]
    new_cache = ({"shift": x[:, -1].clone(), "S": h_t.to(x.dtype)}
                 if cache is not None else None)
    return out, new_cache


def rwkv_channel_mix(p, cfg: ModelConfig, x, *, cache=None):
    """x (B,S,d) -> (out, new_cache). cache = {'shift': (B,d)}."""
    xs = _shift(x, _prev(x, cache))
    xk = x + p["mu_k"].to(x.dtype) * (xs - x)
    h = torch.square(F.relu(xk @ p["w_k"]))
    out = h @ p["w_v"]
    new_cache = {"shift": x[:, -1].clone()} if cache is not None else None
    return out, new_cache
