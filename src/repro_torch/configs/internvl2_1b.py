"""internvl2-1b [vlm] — InternViT + InternLM2/Qwen2 backbone. [arXiv:2404.16821]
24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.

The vision encoder is a stub, as in the reference: the batch carries
precomputed InternViT patch embeddings (frontend_dim=1024, 256 patches);
the learned projector and the language decoder are implemented.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    modality="vision_text",
    frontend_dim=1024,    # InternViT-300M hidden size
    num_patches=256,
    tie_embeddings=True,
    rope_theta=1000000.0,
    source="arXiv:2404.16821 (InternVL2-1B, Qwen2-0.5B backbone)",
)

REDUCED = CONFIG.reduced()
