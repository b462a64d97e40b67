"""qwen2-vl-2b: 28L d=1536 12H (kv 2) ff=8960 vocab=151936. M-RoPE; dynamic
resolution vision frontend is a STUB (precomputed patch embeddings via
input_specs). [arXiv:2409.12191; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab=151936, rope="mrope", act="swiglu", attn_sharding="sp",
    frontend="vlm", frontend_tokens=64,
    source="arXiv:2409.12191",
)
