"""qwen3-4b [dense]: GQA kv=8, qk-norm, RoPE.  36L d=2560 32H d_ff=9728.
[hf:Qwen/Qwen3-8B; hf]  head_dim=128 (q projects to 4096)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
