"""recurrentgemma-2b [hybrid]: Griffin — RG-LRU recurrent blocks + local attn, 1:2.

26L, d_model=2560, 10 heads (MQA kv=1, head_dim 256), d_ff=7680, vocab=256000.
[arXiv:2402.19427; hf]  Pattern (rg, rg, la) cycled; window 2048.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    layer_pattern=("rg", "rg", "la"),
    window_size=2048,
    rnn_width=2560,
    conv_width=4,
    act="geglu",
)
