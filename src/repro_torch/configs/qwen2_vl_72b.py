"""qwen2-vl-72b [vlm]: M-RoPE (sections 16/24/24 over t/h/w), dynamic-resolution
vision frontend stubbed — input_specs() supplies patch+text embeddings.
80L d=8192 64H kv=8 d_ff=29568 vocab=152064.  [arXiv:2409.12191; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29_568,
    vocab_size=152_064,
    mrope_sections=(16, 24, 24),
    embeds_as_input=True,
    rope_theta=1_000_000.0,
)
