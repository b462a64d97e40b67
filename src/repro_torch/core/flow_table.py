"""Flow hash table model (§3.3.3): torch counterpart of
`repro.core.flow_table`.

The simulator keeps per-flow switch state in dense tensors (exact) and uses
this module to model the *capacity* behaviour of the real table: bucket
occupancy, overflow events and memory footprint.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .hashing import bucket_index


@dataclass(frozen=True)
class FlowTableParams:
    n_buckets: int = 8192
    bucket_size: int = 4
    fid_bytes: int = 12      # 5-tuple
    count_bytes: int = 2
    queue_bytes: int = 1

    @property
    def entry_bytes(self) -> int:
        # 12 B FID + 2 B count + 1 B queue + paused bit (paper: 15 B/entry)
        return self.fid_bytes + self.count_bytes + self.queue_bytes

    @property
    def table_bytes(self) -> int:
        return self.n_buckets * self.bucket_size * self.entry_bytes


def buckets_of(fid: torch.Tensor, params: FlowTableParams) -> torch.Tensor:
    return bucket_index(fid, params.n_buckets)


def update(buckets: torch.Tensor, table: torch.Tensor, bucket: torch.Tensor,
           delta: torch.Tensor, params: FlowTableParams = FlowTableParams()):
    """Batched activation(+1)/deactivation(-1) of flows at tables.

    Returns (new_buckets, overflow_events): overflow counts the +1 events
    that landed in an already-full bucket."""
    prev = buckets[table, bucket]
    overflow = ((delta > 0) & (prev >= params.bucket_size)).sum(
        dtype=torch.int32)
    lin = table.long() * buckets.shape[1] + bucket.long()
    new = buckets.reshape(-1).index_add(
        0, lin, delta.to(buckets.dtype)).view(buckets.shape)
    return new, overflow
