"""granite-moe-1b-a400m [moe]: 32 experts top-8, expert d_ff=512.
24L d=1024 16H kv=8 vocab=49155.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=0,                      # all-MoE FFN
    vocab_size=49_155,
    layer_pattern=("gm",),
    n_experts=32,
    n_experts_per_token=8,
    moe_dff=512,
    tie_embeddings=True,
)
