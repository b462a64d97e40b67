"""gemma3-1b: 26L d=1152 4H (kv 1, head_dim 256) ff=6912 vocab=262144.
5 local (window 512) : 1 global layer pattern; 128k-class context.
[hf:google/gemma-3-1b-pt; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab=262144,
    pattern=("local", "local", "local", "local", "local", "attn"),
    window=512, act="geglu", attn_sharding="sp",
    source="hf:google/gemma-3-1b-pt",
)
