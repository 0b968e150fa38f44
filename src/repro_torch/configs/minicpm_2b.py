"""minicpm-2b [dense] — WSD schedule, depth-scaled residuals. [arXiv:2404.06395]
40L d_model=2304 36H (GQA kv=36) d_ff=5760 vocab=122753.

The WSD (warmup-stable-decay) learning-rate schedule belongs to this
config's training recipe, which the port does not run yet: it serves.
"""
import math

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    residual_scale=1.4 / math.sqrt(40),   # MiniCPM scale_depth=1.4
    tie_embeddings=True,
    source="arXiv:2404.06395 (MiniCPM-2B)",
)

REDUCED = CONFIG.reduced()
