"""grok-1-314b: 64L d=6144 48H (kv 8) ff=32768, MoE 8e top-2, vocab 131072.
[hf:xai-org/grok-1; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
    vocab=131072, n_experts=8, top_k=2, act="swiglu",
    attn_sharding="heads", tie_embeddings=False,
    source="hf:xai-org/grok-1",
)
