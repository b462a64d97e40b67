"""starcoder2-15b: 40L d=6144 48H (kv 4) ff=24576 vocab=49152. GQA + RoPE,
non-gated GELU MLP (ff = 4d). [arXiv:2402.19173; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_ff=24576,
    vocab=49152, act="gelu", attn_sharding="heads",
    source="arXiv:2402.19173",
)
