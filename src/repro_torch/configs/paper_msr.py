"""The paper\'s own configuration surface: Double Circulant MSR code presets
(paper §III-D examples + production-scale defaults) and the tiny LM used by
the end-to-end fault-tolerance examples."""
from repro_torch.core.circulant import CodeSpec

from .base import ModelConfig

# paper worked examples
CODE_4_2_F257 = CodeSpec.make(2, p=257, c=[1, 1])      # Fig. 3 (any field)
CODE_6_3_F5 = CodeSpec.make(3, p=5, c=[1, 1, 2])       # Fig. 4 (F_5)
# production default: 16-node storage groups over GF(257)
CODE_16_8_F257 = CodeSpec.make(8, p=257)

CONFIG = ModelConfig(
    name="paper-tiny-lm",
    family="dense",
    n_layers=4,
    d_model=256,
    n_heads=8,
    n_kv_heads=4,
    d_ff=1024,
    vocab_size=4096,
    tie_embeddings=True,
)
