"""Model configuration schema, the port's own copy of
``repro.models.config`` (the port imports nothing of the reference).

Families: dense | moe | ssm | hybrid | vlm | audio, all of which the port
runs; the fields and ``reduced()`` match the reference's. The
distribution hints (``act_dp``, ``act_tp``, ...) are inert here: the
single-device port reads none of them, and the MoE layer refuses
``act_ep`` over more than one device by name.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                   # 0 for attention-free (pure SSM)
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # ---- attention ----
    head_dim: Optional[int] = None   # default: d_model // num_heads
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # None = full attention
    causal: bool = True                    # False for encoder-only (hubert)

    # ---- MoE ----
    num_experts: int = 0
    experts_per_token: int = 0
    moe_layer_period: int = 1        # every p-th layer is MoE (1 = all)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance loss weight
    moe_group_size: int = 2048       # GShard token-group size (bounds the
                                     # one-hot dispatch tensor to g^2-ish)

    # ---- SSM (Mamba2 / SSD, arXiv:2405.21060) ----
    ssm_state: int = 0               # N: state size per head
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_head_dim: int = 64           # P: channels per SSM head
    ssm_ngroups: int = 1             # groups for B/C
    ssm_chunk: int = 256             # SSD chunk length
    conv_kernel: int = 4             # depthwise conv width

    # ---- hybrid (Zamba2, arXiv:2411.15242) ----
    shared_attn_period: int = 0      # every p-th layer applies the shared attn block

    # ---- norms / residuals ----
    norm: str = "rmsnorm"            # rmsnorm | nonparam_ln (OLMo, arXiv:2402.00838)
    norm_eps: float = 1e-5
    residual_scale: float = 1.0      # MiniCPM depth-scaled residual (arXiv:2404.06395)
    logit_scale: float = 1.0         # granite-style logit scaling
    tie_embeddings: bool = True

    # ---- modality frontends (STUBS per instructions) ----
    modality: str = "text"           # text | vision_text | audio
    frontend_dim: int = 0            # dim of precomputed patch/frame embeddings
    num_patches: int = 0             # VLM: patches prepended per example
    encoder_only: bool = False       # hubert: no decode path
    mask_prob: float = 0.08          # hubert masked-prediction probability

    # ---- training memory policy ----
    remat: str = "none"              # none | block (checkpoint each layer)

    # ---- serving memory policy ----
    kv_quant: bool = False           # int8 KV cache (per-token-per-head
                                     # scales); halves the decode memory
                                     # roofline term (EXPERIMENTS §Perf E)

    # ---- distribution hints (set by launch.steps.runtime_config) ----
    # activation sharding constraints: without them GSPMD loses the batch/
    # head sharding inside vmap+scan and replicates activations (measured:
    # 16x compute + TB-scale all-reduces, EXPERIMENTS.md §Perf iter 1).
    act_dp: tuple = ()               # mesh axes for the activation batch dim
    act_tp: Optional[str] = None     # mesh axis for heads/ffn dims
    act_ep: Optional[str] = None     # mesh axis for the expert dim (MoE
                                     # dispatch all-to-all boundary)
    act_ep_size: int = 0             # size of that axis (shard_map dispatch)
    seq_parallel: bool = False       # sequence-sharded residual stream
                                     # between blocks (§Perf iter F)

    # ---- dtypes ----
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    # ---- provenance ----
    source: str = ""                 # citation for the config numbers

    def __post_init__(self):
        if self.head_dim is None and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family in ("moe",) and self.num_experts <= 0:
            raise ValueError(f"{self.name}: moe family requires num_experts>0")
        if self.family in ("ssm", "hybrid") and self.ssm_state <= 0:
            raise ValueError(f"{self.name}: ssm/hybrid family requires ssm_state>0")
        if self.num_heads and self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: num_heads must divide by num_kv_heads")

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_moe_layer(self, layer_idx: int) -> bool:
        return self.num_experts > 0 and (layer_idx % self.moe_layer_period == 0)

    def is_shared_attn_layer(self, layer_idx: int) -> bool:
        """Zamba2-style: a shared attention block every `shared_attn_period` layers."""
        return self.shared_attn_period > 0 and (layer_idx % self.shared_attn_period == 0)

    @property
    def supports_decode(self) -> bool:
        return not self.encoder_only

    @property
    def subquadratic(self) -> bool:
        """True if the arch can run long_500k (O(T) or windowed attention)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized variant of the same family (<=2 layers, d_model<=512,
        <=4 experts) for CPU forward/train-step tests."""
        small = dict(
            num_layers=2,
            d_model=min(self.d_model, 128),
            vocab_size=min(self.vocab_size, 512),
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
        )
        if self.num_heads:
            heads = min(self.num_heads, 4)
            ratio = max(1, self.num_heads // max(self.num_kv_heads, 1))
            small.update(
                num_heads=heads,
                num_kv_heads=max(1, heads // min(ratio, heads)),
                head_dim=32,
            )
        if self.num_experts:
            small.update(num_experts=4, experts_per_token=min(self.experts_per_token, 2))
        if self.ssm_state:
            small.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=32)
        if self.shared_attn_period:
            small.update(shared_attn_period=2)
        if self.sliding_window:
            small.update(sliding_window=64)
        if self.num_patches:
            small.update(num_patches=8, frontend_dim=min(self.frontend_dim, 64))
        if self.frontend_dim and not self.num_patches:
            small.update(frontend_dim=min(self.frontend_dim, 64))
        small["name"] = self.name + "-reduced"
        small.update(overrides)
        return dataclasses.replace(self, **small)
