"""Plain torch version of the RG-LRU scan: the chunked cumsum form of
`repro.models.rglru.chunked_linear_scan`, which is what the JAX prefill
computes. The CPU path of `ops.scan`, and what `chip_smoke.py` holds the
CUDA kernel against. `rglru_scan_tiles_ref` is the CUDA kernel's own
decomposition (tiles of sub-chunk pairs chained along S), for the tests
only."""
from __future__ import annotations

import torch

# the CUDA kernel's tile: its tokens per tile and per thread (kL and kSub
# of csrc/rglru.cu)
TILE, SUB = 128, 16


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


def rglru_scan_tiles_ref(log_a, b, h0):
    """What `csrc/rglru.cu` computes, in its order -> (h_all (B,S,W),
    h_last (B,W)), float32. Used by the tests only.

    The steps compose as pairs (A, B): h -> A h + B. Per sub-chunk of
    SUB tokens, A = prod exp(log_a) and B its h from 0; in a tile of
    TILE tokens, the sub-chunks' exclusive prefixes and the tile's
    aggregate, composed in order; along S, each tile's inclusive h is
    A_tile h_prev + B_tile from h0. Every h_t is then a sequential step
    from its sub-chunk's carry-in. A ragged tail is padded with identity
    steps (log_a = 0, b = 0)."""
    bsz, s, w = b.shape
    nt = -(-s // TILE)
    pad = nt * TILE - s
    la = torch.nn.functional.pad(log_a.float(), (0, 0, 0, pad))
    bb = torch.nn.functional.pad(b.float(), (0, 0, 0, pad))
    e = torch.exp(la).reshape(bsz, nt, TILE // SUB, SUB, w)
    bb = bb.reshape(bsz, nt, TILE // SUB, SUB, w)
    pa = torch.ones_like(e[:, :, :, 0])
    pb = torch.zeros_like(pa)
    for i in range(SUB):                   # each sub-chunk's pair
        pa = pa * e[:, :, :, i]
        pb = e[:, :, :, i] * pb + bb[:, :, :, i]
    ta = torch.ones_like(pa[:, :, 0])
    tb = torch.zeros_like(ta)
    pre_a, pre_b = [], []
    for j in range(TILE // SUB):           # exclusive prefixes, aggregate
        pre_a.append(ta)
        pre_b.append(tb)
        ta, tb = pa[:, :, j] * ta, pa[:, :, j] * tb + pb[:, :, j]
    h = h0.float()
    carries = []
    for t in range(nt):                    # the chain of tiles
        carries.append(h)
        h = ta[:, t] * h + tb[:, t]
    carry = torch.stack(carries, 1)[:, :, None]             # (B,NT,1,W)
    h = torch.stack(pre_a, 2) * carry + torch.stack(pre_b, 2)
    outs = []
    for i in range(SUB):
        h = e[:, :, :, i] * h + bb[:, :, :, i]
        outs.append(h)
    h_all = torch.stack(outs, 3).reshape(bsz, nt * TILE, w)[:, :s]
    return h_all, h_all[:, -1]
