"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088] 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8e top-2. SWA makes long_500k decode O(window) natively.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    experts_per_token=2,
    moe_layer_period=1,
    sliding_window=4096,
    tie_embeddings=False,
    rope_theta=1000000.0,
    source="arXiv:2401.04088 (Mixtral-8x22B)",
)

REDUCED = CONFIG.reduced()
