"""Assigned input-shape sets. Every (arch x shape) pair is one dry-run cell.

  train_4k     seq 4096,   global_batch 256   -> train_step
  prefill_32k  seq 32768,  global_batch 32    -> prefill_step
  decode_32k   cache 32768, global_batch 128  -> serve_step (1 new token)
  long_500k    cache 524288, global_batch 1   -> serve_step; sub-quadratic
               archs only (rwkv6, recurrentgemma, gemma3) — see DESIGN.md
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# archs with sub-quadratic sequence mixing, eligible for long_500k
LONG_CONTEXT_ARCHS = ("rwkv6-3b", "recurrentgemma-2b", "gemma3-1b")


def cells(arch_names):
    """All (arch, shape) dry-run cells honoring the long_500k skip rule."""
    out = []
    for a in arch_names:
        for s in SHAPES.values():
            if s.name == "long_500k" and a not in LONG_CONTEXT_ARCHS:
                continue
            out.append((a, s.name))
    return out
