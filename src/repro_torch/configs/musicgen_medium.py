"""musicgen-medium: 48L d=1536 24H (kv 24 = MHA) ff=6144 vocab=2048.
Decoder-only over EnCodec tokens; sinusoidal positions; non-gated GELU MLP.
The EnCodec/text frontend is a STUB (precomputed frame embeddings).
[arXiv:2306.05284; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab=2048, rope="sinusoidal", act="gelu", attn_sharding="sp",
    frontend="audio", frontend_tokens=64, tie_embeddings=False,
    source="arXiv:2306.05284",
)
