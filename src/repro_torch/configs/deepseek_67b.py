"""deepseek-67b: 95L d=8192 64H (kv 8) ff=22016 vocab=102400 (llama-arch).
[arXiv:2401.02954; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab=102400, act="swiglu", attn_sharding="heads", tie_embeddings=False,
    source="arXiv:2401.02954",
)
