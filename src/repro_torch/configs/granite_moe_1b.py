"""granite-moe-1b-a400m: 24L d=1024 16H (kv 8) per-expert ff=512, 32e top-8,
vocab 49155. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab=49155, n_experts=32, top_k=8, act="swiglu",
    attn_sharding="heads",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
