"""xlstm-1.3b [ssm]: 7:1 mLSTM:sLSTM interleave.  48L d=2048 4 heads vocab=50304,
d_ff=0 (mLSTM blocks carry their own up/down projection).  [arXiv:2405.04517;
unverified]  mLSTM in stabilized parallel form for train/prefill; matrix-memory
recurrence for decode."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    layer_pattern=("ml",) * 7 + ("sl",),
    xlstm_proj_factor=2.0,
)
