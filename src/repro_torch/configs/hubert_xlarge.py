"""hubert-xlarge [audio] — encoder-only, wav2vec2-style backbone.
[arXiv:2106.07447] 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504
(k-means codebook targets).

The audio frontend (mel-spectrogram + conv feature extractor) is a stub,
as in the reference: the batch carries precomputed 512-d frame features.
Encoder-only: there is no decode step.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    encoder_only=True,
    modality="audio",
    frontend_dim=512,     # conv feature extractor output dim (stubbed)
    mask_prob=0.08,
    tie_embeddings=False,
    source="arXiv:2106.07447 (HuBERT X-Large)",
)

REDUCED = CONFIG.reduced()
