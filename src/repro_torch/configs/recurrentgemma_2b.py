"""recurrentgemma-2b: 26L d=2560 10H (kv 1, head_dim 256) ff=7680
vocab=256000. Griffin: RG-LRU + local attention 1:2 (rec,rec,local),
window 2048. [arXiv:2402.19427; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256000, pattern=("rec", "rec", "local"), window=2048,
    rnn_width=2560, conv_width=4, act="geglu", attn_sharding="sp",
    source="arXiv:2402.19427",
)
