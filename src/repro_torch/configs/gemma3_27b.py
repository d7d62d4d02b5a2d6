"""gemma3-27b [dense]: 5:1 local:global interleave, 128k context, GeGLU, qk-norm.
62L d=5376 32H kv=16 head_dim=128 d_ff=21504 vocab=262144.
[hf:google/gemma-3-1b-pt; unverified]  Window 1024 on local layers."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21_504,
    vocab_size=262_144,
    layer_pattern=("la", "la", "la", "la", "la", "ga"),
    window_size=1024,
    qk_norm=True,
    act="geglu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
