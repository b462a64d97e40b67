"""Plain torch version of the flash attention kernel: the twin of
`repro.kernels.flash_attention.ref.attention_ref`. The CPU path of
`ops.attend`, and what `chip_smoke.py` holds the CUDA kernel against."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B,H,S,hd), k/v (B,K,T,hd) -> (B,H,S,hd) in q's dtype. Naive
    materialized softmax in float32; GQA groups q heads by kv head
    (kv head = h // (H/K)); masked scores are -1e30, not -inf, and the
    scale is hd**-0.5."""
    b, h, s, hd = q.shape
    kh, t = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, kh, g, s, hd)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg.float(),
                          k.float()) * (hd ** -0.5)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return out.reshape(b, h, s, hd).to(q.dtype)
