"""Integer hashing utilities shared by the Bloom filter, flow table and ECMP.

Torch counterpart of `repro.core.hashing`. Torch on the CPU implements no
`>>`, `%` or `+` for `uint32`, so every hash computes in int64 holding a
uint32 value and masks back to the low 32 bits after each multiply, add
and shift. Multiplies split the constant into 16-bit halves so that no
intermediate product leaves the int64 range. Results are int64 tensors
holding the uint32 hash (callers cast after their modulo).
"""
from __future__ import annotations

import torch

# Distinct odd multipliers (Knuth / splitmix-style avalanche constants).
_MULTS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1, 0x61C88647)
_M32 = 0xFFFFFFFF


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(uint32)`` as an int64 tensor (two's complement wrap)."""
    return x.to(torch.int64) & _M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _avalanche(x: torch.Tensor) -> torch.Tensor:
    """xorshift-multiply avalanche on uint32."""
    x = as_u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash_u32(x: torch.Tensor, seed: int) -> torch.Tensor:
    """Seeded 32-bit hash. ``x`` integer tensor -> int64 tensor of uint32."""
    x = _mul32(as_u32(x), _MULTS[seed % len(_MULTS)])
    x = (x + ((seed * 0x01000193 + 0x811C9DC5) & _M32)) & _M32
    return _avalanche(x)


def bloom_positions(fid: torch.Tensor, n_stages: int,
                    stage_bits: int) -> torch.Tensor:
    """Per-stage bit positions of ``fid`` in a multistage Bloom filter.

    Returns shape fid.shape + (n_stages,), int32 values in [0, stage_bits).
    """
    pos = [hash_u32(fid, s) % stage_bits for s in range(n_stages)]
    return torch.stack(pos, dim=-1).to(torch.int32)


def bucket_index(fid: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Flow-table bucket for a FID (hash table with 4-entry buckets, §3.3.3)."""
    return (hash_u32(fid, 4) % n_buckets).to(torch.int32)


def ecmp_choice(fid: torch.Tensor, n_paths: int) -> torch.Tensor:
    """Flow-level ECMP: consistent uplink/spine choice per flow."""
    return (hash_u32(fid, 5) % n_paths).to(torch.int32)
