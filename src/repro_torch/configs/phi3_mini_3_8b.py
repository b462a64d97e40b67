"""phi3-mini-3.8b: 32L d=3072 32H (kv 32 = MHA) ff=8192 vocab=32064.
RoPE + SwiGLU. [arXiv:2404.14219; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32064, act="swiglu", attn_sharding="heads",
    source="arXiv:2404.14219",
)
