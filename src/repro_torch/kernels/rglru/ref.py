"""Plain torch version of the RG-LRU scan: the chunked cumsum form of
`repro.models.rglru.chunked_linear_scan`, which is what the JAX prefill
computes. The CPU path of `ops.scan`, and what `chip_smoke.py` holds the
CUDA kernel against."""
from __future__ import annotations

import torch


def rglru_scan_ref(log_a, b, h0, chunk: int = 128):
    """h_t = exp(log_a_t) * h_{t-1} + b_t over axis 1 of (B,S,W); h0 (B,W).
    Returns (h_all (B,S,W), h_last (B,W)), both float32. log_a <= 0.

    Within a chunk: h_i = exp(cs_i) * (h0 + sum_{j<=i} exp(-cs_j) b_j),
    cs the chunk's cumsum of log_a; the carry h chains the chunks."""
    bsz, s, w = b.shape
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    la = log_a.float().reshape(bsz, nc, chunk, w)
    bb = b.float().reshape(bsz, nc, chunk, w)
    csum = torch.cumsum(la, dim=2)
    h = h0.float()
    outs = []
    for c in range(nc):
        cs = csum[:, c]
        inner = torch.cumsum(torch.exp(-cs) * bb[:, c], dim=1)
        h_all = torch.exp(cs) * (inner + h[:, None, :])
        h = h_all[:, -1]
        outs.append(h_all)
    return torch.stack(outs, dim=1).reshape(bsz, s, w), h
