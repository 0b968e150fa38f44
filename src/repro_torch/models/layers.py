"""The layers an SSM language model needs, torch form: initializers, RMSNorm
(and OLMo's non-parametric LayerNorm), the token embedding and the
unembedding.

Port of the matching parts of ``repro.models.layers``. Params are plain
mappings of tensors (a dict, or an ``nn.ParameterDict`` inside a module)
under the reference's names. Initializers draw from an explicit
``torch.Generator`` at the reference's scales; the stream differs from
``jax.random``'s, so parity tests carry the reference's params across.
Attention, RoPE, the MLP and the KV cache are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig


def torch_dtype(name: str) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` -> the torch dtype."""
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, dtype, scale=0.02):
    """``scale * N(0, 1)`` drawn in f32 on the generator's device, then cast
    (the reference's ``_normal``)."""
    return (scale * torch.randn(shape, generator=gen,
                                device=gen.device)).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def apply_norm(params, x, cfg: ModelConfig):
    """RMSNorm (llama family) or non-parametric LayerNorm (OLMo), in f32,
    cast back to x's dtype."""
    dt = x.dtype
    x32 = x.float()
    if cfg.norm == "nonparam_ln":
        mu = x32.mean(-1, keepdim=True)
        var = torch.square(x32 - mu).mean(-1, keepdim=True)
        return ((x32 - mu) * torch.rsqrt(var + cfg.norm_eps)).to(dt)
    ms = torch.square(x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(ms + cfg.norm_eps)
    if params is not None:
        y = y * params["scale"].float()
    return y.to(dt)


def maybe_init_norm(d: int, cfg: ModelConfig, dtype, device):
    return None if cfg.norm == "nonparam_ln" else init_rmsnorm(d, dtype,
                                                               device)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, cfg: ModelConfig, dtype):
    p = {"embed": _normal(gen, (cfg.vocab_size, cfg.d_model), dtype)}
    if not cfg.tie_embeddings:
        p["unembed"] = _normal(gen, (cfg.d_model, cfg.vocab_size), dtype)
    return p


def embed_tokens(params, tokens, cfg: ModelConfig):
    return params["embed"][tokens]


def unembed(params, x, cfg: ModelConfig):
    """f32 logits (..., V): ``x @ embed^T`` when tied."""
    if cfg.tie_embeddings:
        logits = x @ params["embed"].t()
    else:
        logits = x @ params["unembed"]
    return (logits * cfg.logit_scale).float()
