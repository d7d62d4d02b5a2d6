"""whisper-medium [audio]: enc-dec transformer backbone, conv frontend stubbed.

24 enc + 24 dec layers, d_model=1024, 16 heads (MHA), d_ff=4096, vocab=51865.
[arXiv:2212.04356; unverified]  Frontend: input_specs() supplies precomputed
log-mel frame embeddings (b, 1500, d_model); see repro/models/frontend.py.
Positional scheme unified to RoPE across the framework (backbone exercise).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,                 # decoder stack
    encoder_layers=24,
    is_encoder_decoder=True,
    embeds_as_input=True,        # encoder side consumes frame embeddings
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    act="gelu",
    norm="layer",
    tie_embeddings=True,
    encoder_seq=1500,
)
