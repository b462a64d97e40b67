"""Architecture configuration shared by models, configs/ and the launcher:
torch counterpart of `repro.models.config` (dtypes are torch dtypes)."""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Tuple

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense|moe|vlm|audio|hybrid|ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_mode: str = "tp"        # 'tp': experts replicated, ff tensor-sharded
                                # 'ep': experts sharded on `model` (all-to-all
                                #       dispatch); needs n_experts % 16 == 0
    # block pattern, cycled over layers. entries: 'attn','local','rec','rwkv'
    pattern: Tuple[str, ...] = ("attn",)
    window: int = 0             # sliding window for 'local' blocks
    rope: str = "standard"      # 'standard'|'mrope'|'sinusoidal'|'none'
    rope_theta: float = 10_000.0
    act: str = "swiglu"         # 'swiglu'|'geglu'|'gelu'|'relu2'
    rnn_width: int = 0          # RG-LRU recurrence width (0 -> d_model)
    conv_width: int = 4
    rwkv_head_dim: int = 64
    tie_embeddings: bool = True
    frontend: str = "none"      # 'none'|'vlm'|'audio'
    frontend_tokens: int = 64   # stub prefix positions fed by the frontend
    # sharding hints (see runtime/sharding.py)
    attn_sharding: str = "heads"   # 'heads' | 'sp' (sequence parallel)
    # dtypes
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    # notes from the assignment table
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def rnn_w(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def gated(self) -> bool:
        return self.act in ("swiglu", "geglu")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def block_kind(self, layer: int) -> str:
        return self.pattern[layer % len(self.pattern)]

    @property
    def layer_plan(self):
        """(n_full_units, remainder_kinds): scan over repeated pattern units,
        unroll the remainder."""
        u = len(self.pattern)
        n_full = self.n_layers // u
        rem = tuple(self.pattern[i] for i in range(self.n_layers - n_full * u))
        return n_full, rem

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    # ---- analytic parameter counts (for roofline MODEL_FLOPS) ---------------
    def param_count(self) -> int:
        d, hd = self.d_model, self.hd
        total = self.vocab * d  # embeddings
        if not self.tie_embeddings:
            total += self.vocab * d
        for i in range(self.n_layers):
            kind = self.block_kind(i)
            if kind in ("attn", "local"):
                total += d * self.n_heads * hd            # wq
                total += 2 * d * self.n_kv_heads * hd     # wk, wv
                total += self.n_heads * hd * d            # wo
            elif kind == "rec":
                w = self.rnn_w
                total += 2 * d * w + w * d                # in-proj x2, out
                total += self.conv_width * w + w          # conv1d
                total += 2 * w * w + w                    # RG-LRU gates + Lambda
            elif kind == "rwkv":
                total += 5 * d * d                        # r,k,v,g,o
                total += 2 * d * 64 + 64 * d              # decay LoRA
                total += 4 * d                            # mus / bonus
            # mlp
            if self.is_moe:
                n_mat = 3 if self.gated else 2
                total += self.n_experts * n_mat * d * self.d_ff
                total += d * self.n_experts               # router
            elif kind == "rwkv":
                total += 2 * d * self.d_ff                # channel mix (k, v)
            else:
                n_mat = 3 if self.gated else 2
                total += n_mat * d * self.d_ff
            total += 2 * d                                # norms
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        n_mat = 3 if self.gated else 2
        dense_moe = self.n_experts * n_mat * d * self.d_ff
        active_moe = self.top_k * n_mat * d * self.d_ff
        return self.param_count() - self.n_layers * (dense_moe - active_moe)
