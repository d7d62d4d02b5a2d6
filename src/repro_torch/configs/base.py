"""Model configuration dataclass + the shape suite assigned to this paper.

Block kinds (layer_pattern entries, cycled to n_layers):
  "ga" — global attention + dense FFN
  "la" — local (sliding-window) attention + dense FFN
  "gm" — global attention + MoE FFN (optionally + parallel dense residual FFN)
  "rg" — Griffin RG-LRU recurrent block + dense FFN
  "ml" — xLSTM mLSTM block (internal up/down projection, no separate FFN)
  "sl" — xLSTM sLSTM block (+ post MLP)
Encoder-decoder models add an encoder stack of "enc" (bidirectional attn+FFN)
blocks; decoder blocks get a cross-attention sublayer automatically.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None       # default d_model // n_heads
    layer_pattern: tuple[str, ...] = ("ga",)
    window_size: int = 1024           # for "la" blocks
    # attention details
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, int, int] | None = None   # qwen2-vl M-RoPE
    # MoE
    n_experts: int = 0
    n_experts_per_token: int = 0
    moe_dff: int = 0
    dense_residual: bool = False      # arctic: parallel dense FFN next to MoE
    capacity_factor: float = 1.25
    moe_chunk: int = 1024             # sequence chunking for dispatch memory
    # recurrent (Griffin / RG-LRU)
    rnn_width: int | None = None      # default d_model
    conv_width: int = 4
    # xLSTM
    xlstm_proj_factor: float = 2.0    # mLSTM up-projection factor
    slstm_mlp_factor: float = 1.3334  # sLSTM post-MLP factor
    # encoder-decoder
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500           # whisper: 30 s of audio frames (stub)
    # modality frontend stub: model consumes precomputed embeddings
    embeds_as_input: bool = False
    # misc
    act: str = "silu"                 # dense FFN: silu => SwiGLU, gelu => GELU-MLP
    norm: str = "rms"                 # rms | layer
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    logit_softcap: float | None = None
    param_dtype: str = "float32"      # bfloat16 for memory-bound giants (arctic)
    # training
    loss_chunk: int = 512             # sequence chunking of the xent loss

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.rnn_width is None:
            object.__setattr__(self, "rnn_width", self.d_model)
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    # ---- layer pattern expansion -------------------------------------
    def expanded_pattern(self) -> tuple[str, ...]:
        pat = self.layer_pattern
        reps = -(-self.n_layers // len(pat))
        return (pat * reps)[: self.n_layers]

    def cycles(self) -> tuple[int, int]:
        """(n_full_cycles, n_remainder_blocks) for scan-over-superblocks."""
        cl = len(self.layer_pattern)
        return self.n_layers // cl, self.n_layers % cl

    def is_subquadratic(self) -> bool:
        """Eligible for long_500k (DESIGN.md §5): no block attends globally,
        or global blocks are a small minority of a local/recurrent design."""
        kinds = set(self.expanded_pattern())
        if kinds <= {"la", "rg", "ml", "sl"}:
            return True
        n_global = sum(1 for k in self.expanded_pattern() if k in ("ga", "gm"))
        return n_global * 6 <= self.n_layers   # e.g. gemma3's 5:1 local:global

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        cl = len(self.layer_pattern)
        small = dict(
            n_layers=max(2 * cl, cl),          # >= two cycles when possible
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=512,
            window_size=min(self.window_size, 32),
            encoder_seq=32 if self.is_encoder_decoder else self.encoder_seq,
            encoder_layers=min(self.encoder_layers, 2),
            n_experts=min(self.n_experts, 4),
            n_experts_per_token=min(self.n_experts_per_token, 2),
            moe_dff=32 if self.moe_dff else 0,
            moe_chunk=16,
            loss_chunk=32,
            rnn_width=64,
        )
        if self.mrope_sections is not None and "mrope_sections" not in overrides:
            # rescale the M-RoPE sections to the reduced head_dim
            hd = overrides.get("head_dim", small["head_dim"])
            half = hd // 2
            tot = sum(self.mrope_sections)
            secs = [max(1, s * half // tot) for s in self.mrope_sections]
            secs[-1] += half - sum(secs)
            small["mrope_sections"] = tuple(secs)
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


# the assigned LM shape suite (4 shapes x 10 archs = 40 cells)
SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}
