"""llama4-maverick-400b-a17b [moe] — MoE, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E] (assigned spec: 48L d_model=5120 40H
GQA kv=8 d_ff=8192 vocab=202048, MoE 128 experts top-1).

Full attention (no window): the port's prefill runs it over the whole
causal triangle. The reference's long_500k shape overrides
sliding_window=8192 for that shape only (its ``launch.shapes``, not
ported).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=128,
    experts_per_token=1,
    moe_layer_period=1,
    tie_embeddings=False,
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (assigned pool spec)",
)

REDUCED = CONFIG.reduced()
