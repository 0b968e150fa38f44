"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242] 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64. One shared attention+MLP block is reused every 6 layers
(Zamba-style depth weight sharing). Sub-quadratic: runs long_500k.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,           # shared attention block MLP width
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,      # d_inner=7168 -> 112 SSM heads
    ssm_ngroups=1,
    conv_kernel=4,
    shared_attn_period=6,
    sliding_window=4096,  # shared attn block uses SWA for long-context decode
    tie_embeddings=False,
    source="arXiv:2411.15242 (Zamba2-7B)",
)

REDUCED = CONFIG.reduced()
