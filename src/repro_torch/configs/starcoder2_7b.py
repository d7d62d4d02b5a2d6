"""starcoder2-7b [dense]: GQA kv=4, RoPE, plain-GELU MLP, LayerNorm.
32L d=4608 36H d_ff=18432 vocab=49152.  [arXiv:2402.19173; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18_432,
    vocab_size=49_152,
    act="gelu",
    norm="layer",
    rope_theta=1_000_000.0,
)
