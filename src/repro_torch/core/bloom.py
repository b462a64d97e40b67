"""Multistage counting Bloom filter (paper §3.3.2, Fig. 8).

Torch counterpart of `repro.core.bloom`: dense integer tensors so that one
filter per link updates in parallel.

  counts : (..., n_stages, stage_bits) int32   -- counting filter at the switch
  bits   : (..., n_stages, stage_bits) bool    -- snapshot shipped upstream

A flow matches iff its bit is set in *every* stage.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .hashing import bloom_positions


@dataclass(frozen=True)
class BloomParams:
    n_stages: int = 4
    stage_bits: int = 256  # 4 stages x 256 bits = 128 B, paper's default

    @property
    def size_bytes(self) -> int:
        return self.n_stages * self.stage_bits // 8


def empty_counts(params: BloomParams, *lead_shape: int,
                 device="cpu") -> torch.Tensor:
    return torch.zeros(lead_shape + (params.n_stages, params.stage_bits),
                       dtype=torch.int32, device=device)


def positions(fid: torch.Tensor, params: BloomParams) -> torch.Tensor:
    """Bit positions per stage: shape fid.shape + (n_stages,)."""
    return bloom_positions(fid, params.n_stages, params.stage_bits)


def add_batch(counts: torch.Tensor, filt: torch.Tensor, pos: torch.Tensor,
              delta: torch.Tensor) -> torch.Tensor:
    """Batched counter update across many filters at once (out of place).

    counts : (n_filters, n_stages, stage_bits) int32
    filt   : (n,) filter index per event, in range (invalid events use any
             valid index with delta 0)
    pos    : (n, n_stages) bit positions
    delta  : (n,) int32 (+1 pause, -1 resume, 0 no-op)
    """
    n_stages, bits = counts.shape[-2], counts.shape[-1]
    stage = torch.arange(n_stages, dtype=torch.int32, device=counts.device)
    lin = (filt[:, None] * n_stages + stage[None, :]) * bits + pos
    d = delta.to(counts.dtype)[:, None].expand(pos.shape)
    return counts.reshape(-1).index_add(
        0, lin.reshape(-1), d.reshape(-1)).view(counts.shape)


def snapshot(counts: torch.Tensor) -> torch.Tensor:
    """The bit filter actually shipped on the wire: counter > 0."""
    return counts > 0


def check(bits: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Membership test of FIDs against snapshot(s): True = paused."""
    got = torch.gather(bits, -1, pos.long()[..., None])[..., 0]
    return got.all(dim=-1)
