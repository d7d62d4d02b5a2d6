"""arctic-480b [moe]: 128 experts top-2 PLUS parallel dense residual FFN.
35L d=7168 56H kv=8 expert d_ff=4864 vocab=32000.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,                   # dense residual branch width
    vocab_size=32_000,
    layer_pattern=("gm",),
    n_experts=128,
    n_experts_per_token=2,
    moe_dff=4864,
    dense_residual=True,
    # 480B fp32 params + fp32 moments = 5.76 TB > a 256-chip v5e pod's 4 TB
    # HBM: store params (and, via dryrun policy, moments) in bf16.  See
    # EXPERIMENTS.md §Dry-run for the memory ledger.
    param_dtype="bfloat16",
)
