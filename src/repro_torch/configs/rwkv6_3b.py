"""rwkv6-3b (Finch): 32L d=2560 attention-free, ff=8960 vocab=65536.
Data-dependent per-channel decay; head_dim 64. [arXiv:2404.05892; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=8960,
    vocab=65536, pattern=("rwkv",), rope="none", rwkv_head_dim=64,
    act="relu2", attn_sharding="sp",
    source="arXiv:2404.05892",
)
