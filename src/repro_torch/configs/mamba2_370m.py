"""mamba2-370m [ssm] — SSD (state-space duality). [arXiv:2405.21060]
48L d_model=1024 (attention-free) vocab=50280, ssm_state=128."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,          # attention-free
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,      # d_inner=2048 -> 32 SSM heads
    ssm_ngroups=1,
    conv_kernel=4,
    tie_embeddings=True,
    source="arXiv:2405.21060 (Mamba2-370m)",
)

REDUCED = CONFIG.reduced()
