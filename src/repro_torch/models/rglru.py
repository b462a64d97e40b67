"""Griffin/RecurrentGemma recurrent block: conv1d + RG-LRU gated linear
recurrence (arXiv:2402.19427); torch counterpart of `repro.models.rglru`.

    r_t = sigmoid(W_a x_t)              (recurrence gate)
    i_t = sigmoid(W_x x_t)              (input gate)
    log a_t = -c * softplus(Lambda) * r_t            (c = 8)
    h_t = a_t . h_{t-1} + sqrt(1 - a_t^2) . (i_t . x_t)

Over more than one token the recurrence runs through
`kernels.rglru.ops.scan` (the CUDA kernel on the card, the chunked cumsum
form on the CPU); a single decode step stays plain torch, as in JAX.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.rglru import ops
from .config import ModelConfig
from .layers import gelu
from .nn import Initializer

_C = 8.0  # Griffin's recurrence-gate temperature


def init_rglru(ini: Initializer, cfg: ModelConfig):
    d, w = cfg.d_model, cfg.rnn_w
    ini.param("w_in", (d, w), init="fan_in")
    ini.param("w_gate", (d, w), init="fan_in")
    ini.param("w_out", (w, d), init="fan_in")
    ini.param("conv_w", (cfg.conv_width, w), init="fan_in")
    ini.param("conv_b", (w,), init="zeros")
    ini.param("w_a", (w, w), init="fan_in")
    ini.param("w_x", (w, w), init="fan_in")
    # Lambda parameterized so a^c starts in [0.9, 0.999]
    ini.param("lam", (w,), init="uniform", scale=1.0)


def rglru_block(p, cfg: ModelConfig, x, *, cache=None):
    """x (B,S,d) -> (out, new_cache). cache = {'h': (B,W), 'conv':
    (B,cw-1,W)}."""
    bsz, s, d = x.shape
    w = cfg.rnn_w
    dt = x.dtype
    xb = x @ p["w_in"]                         # (B,S,W)
    gate = x @ p["w_gate"]

    # causal depthwise conv1d (width cw)
    cw = cfg.conv_width
    prev = (cache["conv"] if cache is not None
            else torch.zeros((bsz, cw - 1, w), dtype=dt, device=x.device))
    xpad = torch.cat([prev, xb], dim=1)                 # (B, S+cw-1, W)
    conv = sum(xpad[:, i:i + s] * p["conv_w"][i] for i in range(cw))
    conv = conv + p["conv_b"]
    new_conv = xpad[:, -(cw - 1):] if cw > 1 else prev

    # RG-LRU gates
    r = torch.sigmoid(conv @ p["w_a"]).float()
    i = torch.sigmoid(conv @ p["w_x"]).float()
    # a = exp(-c * 0.01 * softplus(lam) * r): a ~ 0.95 at init (Griffin's
    # [0.9, 0.999] initialization band)
    lam_sp = F.softplus(p["lam"].float())
    log_a = -_C * 0.01 * lam_sp * r - 1e-6                 # < 0
    a2 = torch.exp(2 * log_a)
    b = torch.sqrt(torch.clamp(1 - a2, min=1e-9)) * (i * conv.float())

    h0 = (cache["h"].float() if cache is not None
          else torch.zeros((bsz, w), dtype=torch.float32, device=x.device))
    if s == 1:
        h = torch.exp(log_a[:, 0]) * h0 + b[:, 0]
        hs = h[:, None]
        h_last = h
    else:
        assert s % min(128, s) == 0, f"s={s} is not a multiple of 128"
        hs, h_last = ops.scan(log_a, b, h0)

    out = (hs.to(dt) * gelu(gate)) @ p["w_out"]
    new_cache = ({"h": h_last.to(dt), "conv": new_conv}
                 if cache is not None else None)
    return out, new_cache
